"""Post-training INT8 quantization: calibration and int8 (w8a16) weights.

Counterpart of ``odtk_tpu/quantize.py``:

  * ``capture_activation_absmax`` — one calibration pass over an image
    batch that records each convolution's input absmax (or a percentile
    of |input|) by forward pre-hooks on every ``nn.Conv2d``, the layers
    the JAX package builds as ``QuantConv``; ``capture_activation_hist``
    the 2048-bin |input| histograms of the entropy calibrator's second
    pass. ``export.calibrate`` merges them over the calibration set and
    persists the table.
  * ``build_quant_variables`` — swaps each calibrated convolution for a
    ``QuantConv2d`` holding int8 per-output-channel weights and their fp32
    scales (the w8a16 form that ``export_model`` uses: weights
    dequantized in the graph, activations in the compute dtype).
  * ``quantize_weights``/``dequantize_weights``/``quantize_model`` — the
    storage-only helpers and the fake-quant experiment path.

Table keys are the port's module names (``backbones.ResNet50FPN.features.
layer1.0.conv1``, ``cls_head.0``); ``io/jax_bridge.py`` maps them to the
JAX package's flax paths. A head convolution runs once per FPN level:
its absmax and percentile merge over the levels by maximum, its
histogram by sum, as the JAX package's ``sow`` reductions do.
"""

import numpy as np
import torch
from torch import nn

HIST_BINS = 2048      # raw |input| histogram resolution
QUANT_BINS = 128      # int8 positive levels


def _quantize_kernel(weight):
    """Symmetric per-output-channel int8 of an OIHW weight: (q int8,
    scale fp32 [O]) with scale = max(absmax, 1e-8) / 127 and q rounded
    half to even (``odtk_tpu/quantize.py:_quantize_kernel`` on HWIO)."""
    w = weight.detach().float()
    absmax = w.abs().reshape(w.shape[0], -1).amax(1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale.reshape(-1, *[1] * (w.dim() - 1))),
                    -127, 127).to(torch.int8)
    return q, scale


# ------------------------------------------------------------- calibration

def percentile(a, p):
    """``jnp.percentile(a, p)`` (linear interpolation) of a flat fp32
    tensor, any size: the sorted values at floor and ceil of
    p/100 * (n - 1), weighted in fp32 as JAX weights them.
    ``torch.quantile`` refuses inputs over 16M elements."""
    n = a.numel()
    q = np.float32(np.float32(p) / np.float32(100.0)) * np.float32(n - 1)
    low, high = int(np.floor(q)), int(np.ceil(q))
    high_w = np.float32(q - np.float32(low))
    low_w = np.float32(1.0) - high_w
    vals = torch.sort(a).values
    return vals[low] * float(low_w) + vals[high] * float(high_w)


def _capture(model, images, stat, merge):
    """Run ``model.heads`` on images with a pre-hook on every convolution;
    {name: merged stat of its inputs}, stats as CPU values."""
    out = {}

    def hook(name):
        def fn(_module, args):
            value = stat(name, args[0].detach().float())
            if value is not None:
                out[name] = value if name not in out else merge(out[name],
                                                                 value)
        return fn

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in model.module.named_modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model.heads(images)
    finally:
        for h in handles:
            h.remove()
    return {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in out.items()}


def capture_activation_absmax(model, images, percentile_value=None):
    """{conv name: float} for one batch: the max of |input| (or, with a
    percentile, that percentile of |input|), max-merged over the calls
    of a layer."""
    def stat(_name, x):
        a = x.abs()
        if percentile_value is None:
            return a.max()
        return percentile(a.reshape(-1), percentile_value)

    table = _capture(model, images, stat, torch.maximum)
    return {k: float(v) for k, v in table.items()}


def capture_activation_hist(model, images, absmax, nbins=HIST_BINS):
    """{conv name: float64 [nbins] counts} of |input| over [0, absmax]
    for one batch, summed over the calls of a layer; bin
    clip(int(|x| * nbins / absmax), 0, nbins - 1) as the JAX package
    bins. Layers with no positive absmax are left out."""
    def stat(name, x):
        amax = float(absmax.get(name, 0.0))
        if amax <= 0.0:
            return None
        idx = (x.abs().reshape(-1) * (nbins / amax)).to(torch.int32)
        idx = idx.clamp(0, nbins - 1).long()
        return torch.bincount(idx, minlength=nbins).double()

    table = _capture(model, images, stat, torch.add)
    return {k: v.numpy() for k, v in table.items()}


def merge_absmax(a, b):
    """Running max of two flat absmax tables."""
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in set(a) | set(b)}


def merge_hist(a, b):
    """Elementwise-add two flat histogram tables."""
    out = dict(a)
    for k, v in b.items():
        out[k] = out[k] + v if k in out else v
    return out


# --------------------------------------------- entropy (KL) calibration

def entropy_threshold(hist, bin_width, target_bins=QUANT_BINS):
    """KL-optimal clipping threshold for one layer's |input| histogram,
    the TensorRT IInt8EntropyCalibrator2 rule, copied from
    ``odtk_tpu/quantize.py:entropy_threshold``: for every candidate clip
    point i >= target_bins, fold the outlier mass into the last kept bin
    (P), resample the kept bins to target_bins levels and expand back
    over P's support (Q), and keep the i minimizing KL(P||Q). Returns the
    threshold in input units (i * bin_width)."""
    hist = np.asarray(hist, np.float64)
    n = len(hist)
    total = hist.sum()
    if total <= 0 or n <= target_bins:
        return n * bin_width
    best_kl, best_i = np.inf, n
    nz = hist > 0
    for i in range(target_bins, n + 1):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()          # clip: outliers -> edge bin
        psum = p.sum()
        if psum <= 0:
            continue
        group = np.arange(i) * target_bins // i
        q_counts = np.bincount(group, weights=hist[:i],
                               minlength=target_bins)
        nz_per_group = np.bincount(group, weights=nz[:i].astype(np.float64),
                                   minlength=target_bins)
        # expand each quantized level uniformly over its nonzero support
        expand = np.zeros(i)
        support = nz[:i] & (nz_per_group[group] > 0)
        ratio = np.divide(q_counts[group], nz_per_group[group],
                          out=np.zeros(i), where=nz_per_group[group] > 0)
        expand[support] = ratio[support]
        mask = p > 0
        if (expand[mask] == 0).any():
            # P has mass where Q has none: infinite KL, skip this point
            continue
        pm, qm = p[mask] / psum, expand[mask] / expand.sum()
        kl = float(np.sum(pm * np.log(pm / qm)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i * bin_width


def entropy_thresholds(hist_table, absmax_table, nbins=HIST_BINS):
    """Per-layer KL thresholds: {name: threshold} in input units."""
    out = {}
    for key, amax in absmax_table.items():
        hist = hist_table.get(key)
        if hist is None or amax <= 0:
            out[key] = amax
        else:
            out[key] = float(entropy_threshold(hist, amax / nbins))
    return out


# ------------------------------------------------------- engine weights

def build_quant_variables(module, act_absmax, mode='w8a16'):
    """Swap every ``nn.Conv2d`` of ``module`` whose name has a calibrated
    range in ``act_absmax`` for a ``QuantConv2d`` with int8
    per-output-channel weights (in place). Returns (module, stats) with
    the JAX package's stats keys.

    Only ``mode='w8a16'`` is ported: PyTorch has no int8 convolution for
    the w8a8 form (``odtk_tpu/backbones/layers.py:265-305``)."""
    from .backbones.layers import QuantConv2d

    if mode != 'w8a16':
        raise NotImplementedError(
            f'quantization mode {mode!r} is not ported yet (ROADMAP Queue 1 '
            'item 10, w8a8 int8 convolutions); use w8a16')
    n_q, fp_bytes, q_bytes = 0, 0, 0
    for name, conv in list(module.named_modules()):
        if not isinstance(conv, nn.Conv2d) or name not in act_absmax:
            continue
        q, w_scale = _quantize_kernel(conv.weight)
        fp_bytes += conv.weight.numel() * 4
        q_bytes += q.numel() + w_scale.numel() * 4
        parent, _, leaf = name.rpartition('.')
        owner = module.get_submodule(parent) if parent else module
        setattr(owner, leaf, QuantConv2d.from_conv(conv, q, w_scale))
        n_q += 1
    stats = {'quantized_tensors': n_q, 'fp32_bytes': int(fp_bytes),
             'int8_bytes': int(q_bytes),
             'ratio': fp_bytes / max(q_bytes, 1)}
    return module, stats


# ------------------------------------------------- storage-only helpers

def quantize_weights(state_dict, skip_substrings=('bn', 'frozen')):
    """state_dict -> ({key: {'q': int8, 'scale': fp32 [O]} for each 4-D
    convolution weight, else the tensor}, meta). Biases and 1-D tensors
    stay fp32."""
    out = {}
    n_q = 0
    for key, value in state_dict.items():
        if value.dim() == 4 and not any(s in key for s in skip_substrings):
            q, scale = _quantize_kernel(value)
            out[key] = {'q': q, 'scale': scale}
            n_q += 1
        else:
            out[key] = value.detach().clone()
    return out, {'quantized_tensors': n_q}


def dequantize_weights(qparams, dtype=torch.bfloat16):
    """Inverse of ``quantize_weights``: a state_dict, the quantized
    weights as q * scale in ``dtype``."""
    out = {}
    for key, v in qparams.items():
        if isinstance(v, dict) and 'q' in v:
            scale = v['scale'].reshape(-1, *[1] * (v['q'].dim() - 1))
            out[key] = v['q'].to(dtype) * scale.to(dtype)
        else:
            out[key] = v
    return out


def quantize_model(model):
    """FAKE-quant experiment path: the model's parameters replaced in
    place by their int8 round trip (fp32 weights carrying int8 rounding
    noise), to isolate the weight quantization's effect. Real engines use
    ``build_quant_variables``. Returns size statistics."""
    params = {k: p for k, p in model.module.named_parameters()}
    qparams, meta = quantize_weights(params)
    deq = dequantize_weights(qparams, torch.float32)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(deq[k])
    raw = sum(p.numel() * 4 for p in params.values())
    comp = sum((v['q'].numel() + v['scale'].numel() * 4)
               if isinstance(v, dict) else v.numel() * 4
               for v in qparams.values())
    return {'fp32_bytes': int(raw), 'int8_bytes': int(comp),
            'ratio': raw / comp, **meta}
