"""Focal loss and smooth-L1, elementwise and dense.

Counterpart of ``odtk_tpu/ops/losses.py``. Computed in fp32 whatever the
network's compute dtype; the model normalizes the sums by the
foreground count. These are the plain forms: the model's path runs the
fused kernel of ``ops/kernels/loss.py``, whose plain version is built
from them.
"""

import torch


def focal_loss(logits, targets, alpha=0.25, gamma=2.0):
    """Elementwise sigmoid focal loss (https://arxiv.org/abs/1708.02002):
    BCE-with-logits weighted by alpha_t * (1 - p_t)^gamma. fp32, or
    float64 for float64 logits (the kernels' checks' reference)."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logits = logits.to(dtype)
    targets = targets.to(dtype)
    p = torch.sigmoid(logits)
    # stable BCE with logits: max(x, 0) - x*t + log(1 + exp(-|x|))
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    alpha_t = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    p_t = torch.where(targets == 1, p, 1.0 - p)
    return alpha_t * (1.0 - p_t) ** gamma * ce


def smooth_l1_loss(pred, target, beta=0.11):
    """Elementwise smooth-L1 (Huber) with threshold beta. fp32, or float64
    for float64 predictions (the kernels' checks' reference)."""
    dtype = torch.promote_types(pred.dtype, torch.float32)
    x = (pred.to(dtype) - target.to(dtype)).abs()
    return torch.where(x >= beta, x - 0.5 * beta, 0.5 * x * x / beta)
