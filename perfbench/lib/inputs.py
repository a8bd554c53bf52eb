"""The general traffic generator: inputs made from ``--seed`` by the
parameters of a traffic mix (``perfbench/traffic/<mix>.json``).

Images are smooth random pictures (bilinear upsampled noise) of the
mix's valid size on its padded canvas, u8 NHWC, as the loader emits
them. Training images carry boxes and the per-image colour affine of
the CLI's default jitter; eval images carry only their valid size.
Everything is drawn on ``device`` from one generator in a few calls and
kept in pinned host memory, from where each step or request copies it
to the card. Every seed gets the same multiset of box counts (spread
evenly over the mix's range), shuffled, so a seed changes what the
boxes are, not how many there are.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.retinanet import MEAN, STD

GRAY = np.asarray([0.299, 0.587, 0.114])


def _stream(seed, *salt):
    """A distinct 63-bit seed for each use of one run seed."""
    value = int(seed) & (2 ** 64 - 1)
    for s in salt:
        value = (value * 1_000_003 + s + 1) % (2 ** 63 - 1)
    return value


def _images(g, n, mix, device):
    h, w = mix['valid']
    ch, cw = mix['canvas']
    low = torch.rand(n, 3, max(h // 16, 2), max(w // 16, 2), generator=g,
                     device=device)
    pic = F.interpolate(low, size=(h, w), mode='bilinear',
                        align_corners=False)
    u8 = torch.zeros(n, ch, cw, 3, dtype=torch.uint8, device=device)
    u8[:, :h, :w] = (pic * 255).round().clamp(0, 255).to(torch.uint8) \
        .permute(0, 2, 3, 1)
    return u8


def _hue_matrix(f):
    """The hue rotation by f of a turn in YIQ space, as a 3 x 3 matrix
    acting on row vectors."""
    th = 2.0 * math.pi * f
    u, v = math.cos(th), math.sin(th)
    m = np.asarray([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                    [0.211, -0.523, 0.312]])
    rot = np.asarray([[1, 0, 0], [0, u, -v], [0, v, u]])
    return (np.linalg.inv(m) @ rot @ m).T


def color_affines(jitter, draws, mean_gray):
    """[n, 3, 4] folded jitter + normalize affines: brightness fb,
    contrast fc toward the image's mean gray, saturation fs toward each
    pixel's gray, hue rotation fh; then (x / 255 - mean) / std. ``draws``
    [n, 4] standard normals; ``mean_gray`` [n] in [0, 1]."""
    mean, std = np.asarray(MEAN), np.asarray(STD)
    out = np.zeros((len(draws), 3, 4), np.float32)
    for i, (zb, zc, zs, zh) in enumerate(draws):
        fb = max(0.0, 1 + jitter['brightness'] * zb)
        fc = max(0.0, 1 + jitter['contrast'] * zc)
        fs = max(0.0, 1 + jitter['saturation'] * zs)
        fh = float(np.clip(jitter['hue'] * zh, -0.5, 0.5))
        a, b = fb * fc * fs, fb * fc * (1 - fs)
        c = fb * (1 - fc) * mean_gray[i]
        t = _hue_matrix(fh) * a if fh else np.eye(3) * a
        t = t + np.outer(GRAY, np.full(3, b))
        out[i, :, :3] = t / (255.0 * std[None, :])
        out[i, :, 3] = (c - mean) / std
    return out


def _boxes(g, counts, mix, max_det, classes, device):
    """[n, max_det, 5] targets (x, y, w, h, class), -1 padded: sides
    log-uniform over the mix's range, clipped to the valid image."""
    n = len(counts)
    h, w = mix['valid']
    lo, hi = (math.log(v) for v in mix['box_sides'])
    u = torch.rand(n, max_det, 4, generator=g, device=device)
    cls = torch.randint(0, classes, (n, max_det), generator=g, device=device)
    bw = torch.exp(lo + (hi - lo) * u[..., 0]).clamp(max=w).floor()
    bh = torch.exp(lo + (hi - lo) * u[..., 1]).clamp(max=h).floor()
    x = ((w - bw) * u[..., 2]).floor()
    y = ((h - bh) * u[..., 3]).floor()
    t = torch.stack([x, y, bw, bh, cls.float()], -1)
    live = (torch.arange(max_det, device=device)[None]
            < torch.as_tensor(counts, device=device)[:, None])
    return torch.where(live[..., None], t, -1.0)


def _pin(t, device):
    t = t.cpu()
    return t.pin_memory() if torch.device(device).type == 'cuda' else t


def train_pool(seed, mix, classes, device):
    """``mix['pool']`` batches of ``mix['batch']`` training images: a
    list of dicts of pinned host tensors ``images`` u8 [B, H, W, 3],
    ``targets`` [B, max_det, 5], ``colors`` [B, 3, 4], ``sizes`` [B, 2]."""
    b, pool = mix['batch'], mix['pool']
    n = b * pool
    g = torch.Generator(device=device).manual_seed(_stream(seed, 1, 0))
    images = _images(g, n, mix, device)
    lo, hi = mix['boxes_per_image']
    counts = np.round(np.linspace(lo, hi, n)).astype(int)
    counts = counts[torch.randperm(n, generator=g, device=device).cpu()]
    targets = _boxes(g, counts, mix, mix['max_det'], classes, device)
    draws = torch.randn(n, 4, generator=g, device=device).double().cpu()
    h, w = mix['valid']
    gray = (images[:, :h, :w].double() @ torch.as_tensor(
        GRAY, device=device)).mean(dim=(1, 2)) / 255.0
    colors = torch.from_numpy(color_affines(mix['jitter'], draws.numpy(),
                                            gray.cpu().numpy()))
    sizes = torch.tensor([[h, w]] * n, dtype=torch.float32)
    return [{'images': _pin(images[i * b:(i + 1) * b], device),
             'targets': _pin(targets[i * b:(i + 1) * b], device),
             'colors': _pin(colors[i * b:(i + 1) * b], device),
             'sizes': _pin(sizes[i * b:(i + 1) * b], device)}
            for i in range(pool)]


def eval_pool(seed, mix, device):
    """``mix['pool']`` distinct eval images as ``pool // batch`` request
    batches: dicts of pinned ``images`` u8 [B, H, W, 3] and ``sizes``."""
    b, n = mix['batch'], mix['pool']
    g = torch.Generator(device=device).manual_seed(_stream(seed, 2))
    images = _images(g, n, mix, device)
    h, w = mix['valid']
    sizes = torch.tensor([[h, w]] * b, dtype=torch.float32)
    return [{'images': _pin(images[i:i + b], device),
             'sizes': _pin(sizes, device)}
            for i in range(0, n, b)]


def to_device(batch, device, non_blocking=True):
    return {k: v.to(device, non_blocking=non_blocking)
            for k, v in batch.items()}
