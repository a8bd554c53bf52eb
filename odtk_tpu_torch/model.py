"""RetinaNet: the module and the user-facing ``Model`` wrapper.

Counterpart of ``odtk_tpu/model.py``. ``RetinaNet`` holds the backbones
and the shared heads and runs the forward pass in NCHW; ``Model`` owns
the hyperparameters, the anchor tables, the loss and inference functions
and checkpoint I/O.

Module names give the reference's torch keys
(``backbones.<Name>.features.layer1.0.conv1.weight``,
``backbones.<Name>.lateral3.weight``, ``cls_head.{0,2,4,6,8}.weight``),
so a ``.pth`` written by the JAX package loads with ``strict=True``.

Public layouts are the JAX package's: images are NHWC and the heads are
returned as NHWC [B, H, W, A*K] maps with channel c = a*K + k. A
rotated-box model (``rotated_bbox=True``) has ratios x scales x angles
anchors and a box head of 6 channels per anchor (deltas, sin, cos).

Precision (``set_dtype``): the parameters stay fp32 and are the ones
trained; a bf16 run computes under ``torch.autocast``, which casts each
convolution's weights and inputs to bf16 on the fly, as the JAX
package's ``dtype=bf16, param_dtype=fp32`` convolutions do. The frozen
batch-norm statistics stay fp32 and are folded in fp32.
"""

import math

import torch
from torch import nn

from . import backbones as backbones_mod
from . import parallel
from .ops import (decode, decode_fused, eval_normalize_u8, generate_anchors,
                  generate_anchors_rotated, nms, nms_rotated,
                  snap_to_anchors, snap_to_anchors_rotated_levels)
from .ops.kernels.loss import detection_loss_sums_levels


def _head(out_channels):
    """4 x (3x3 conv 256 + ReLU), then a 3x3 conv to ``out_channels``:
    Sequential indices 0, 2, 4, 6, 8 are the convs."""
    layers = []
    for _ in range(4):
        layers += [nn.Conv2d(256, 256, 3, padding=1), nn.ReLU()]
    layers.append(nn.Conv2d(256, out_channels, 3, padding=1))
    return nn.Sequential(*layers)


class RetinaNet(nn.Module):
    """Backbones + shared classification / box heads (NCHW)."""

    def __init__(self, backbone_names=('ResNet50FPN',), classes=80,
                 num_anchors=9, rotated=False):
        super().__init__()
        self.rotated = rotated
        self.backbones = nn.ModuleDict(
            {name: backbones_mod.build(name) for name in backbone_names})
        self.cls_head = _head(classes * num_anchors)
        self.box_head = _head((6 if rotated else 4) * num_anchors)

    def forward(self, x):
        """x [B, 3, H, W] -> (cls_heads, box_heads), lists of NCHW logits."""
        features = []
        for net in self.backbones.values():
            features.extend(net(x))
        return ([self.cls_head(f) for f in features],
                [self.box_head(f) for f in features])

    def initialize(self, generator):
        """Seeded random init: Kaiming-normal (fan_out) backbone convs,
        Xavier-uniform FPN convs, N(0, 0.01) head convs, zero biases and
        the pi = 0.01 prior on the final classification bias, and on the
        final box bias of a rotated model (``odtk_tpu/model.py:73-96``)."""
        for net in self.backbones.values():
            for name, m in net.named_modules():
                if not isinstance(m, nn.Conv2d):
                    continue
                if name.startswith('features.'):
                    nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                            nonlinearity='relu',
                                            generator=generator)
                else:
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for head in (self.cls_head, self.box_head):
            for m in head:
                if isinstance(m, nn.Conv2d):
                    nn.init.normal_(m.weight, std=0.01, generator=generator)
                    nn.init.zeros_(m.bias)
        pi = 0.01
        finals = [self.cls_head[-1]] + ([self.box_head[-1]] if self.rotated
                                        else [])
        for conv in finals:
            nn.init.constant_(conv.bias, -math.log((1 - pi) / pi))


class Model:
    """User-facing model: hyperparameters, anchors, loss, inference,
    checkpoints.

    Mirrors ``odtk_tpu.model.Model``: axis-aligned boxes, or rotated
    ones with ``rotated_bbox`` (``angles`` default [-pi/6, 0, pi/6]).
    ``config`` carries threshold / top_n / nms / detections /
    decode_fused / fused_top_n. The module is built on the CPU;
    ``initialize`` draws its weights there and ``to(device)`` moves it.
    """

    stride = 128             # input padding stride (FPN)

    def __init__(self, backbones='ResNet50FPN', classes=80,
                 ratios=(1.0, 2.0, 0.5),
                 scales=tuple(4 * 2 ** (i / 3) for i in range(3)),
                 angles=None, rotated_bbox=False, anchor_ious=(0.4, 0.5),
                 config=None):
        if not isinstance(backbones, (list, tuple)):
            backbones = [backbones]
        config = dict(config or {})
        self.backbones = list(backbones)
        self.name = 'RetinaNet'
        self.classes = classes
        self.ratios = list(ratios)
        self.scales = list(scales)
        self.rotated_bbox = rotated_bbox
        self.angles = (list(angles) if angles is not None else
                       [-math.pi / 6, 0, math.pi / 6] if rotated_bbox
                       else None)
        self.anchor_ious = tuple(anchor_ious)
        self.threshold = config.get('threshold', 0.05)
        self.top_n = config.get('top_n', 1000)
        self.nms = config.get('nms', 0.5)
        self.detections = config.get('detections', 100)
        # one global top-k of 2 x top_n over all levels (decode_fused);
        # config {'decode_fused': False} selects per level instead
        self.decode_fused = config.get('decode_fused', True)
        self.fused_top_n = config.get('fused_top_n', 2 * self.top_n)
        self.num_anchors = len(self.ratios) * len(self.scales)
        if rotated_bbox:
            self.num_anchors *= len(self.angles)
        self.box_size = 6 if rotated_bbox else 4

        self.module = RetinaNet(tuple(self.backbones), classes,
                                self.num_anchors, rotated_bbox).eval()
        self.device = torch.device('cpu')
        self.dtype = torch.float32
        self._anchors = {}
        self._anchor_tensors = {}

    def __repr__(self):
        return '\n'.join([
            '     model: {}'.format(self.name),
            '  backbone: {}'.format(', '.join(self.backbones)),
            '   classes: {}, anchors: {}'.format(self.classes,
                                                 self.num_anchors)])

    def initialize(self, generator=0, fine_tune=None):
        """Draw random weights from ``generator`` (a CPU torch.Generator,
        or an int seed for one); the module must still be on the CPU.

        ``fine_tune``: a ``.pth`` or ``.ckpt`` checkpoint whose weights replace
        the drawn ones, module by module (the backbone, each head conv),
        where every tensor of the module is present with the same shape;
        the final classification conv ``cls_head.8`` is never copied,
        nor ``box_head.8`` of a rotated model
        (``odtk_tpu/model.py:252-283``)."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        self.module.initialize(generator)
        if fine_tune is not None:
            from .io import checkpoint
            donor = checkpoint.read(fine_tune)['state_dict']
            own = self.module.state_dict()
            groups = {}
            for key in own:
                groups.setdefault('.'.join(key.split('.')[:2]), []).append(key)
            skip = {'cls_head.8'} | ({'box_head.8'} if self.rotated_bbox
                                     else set())
            graft = {}
            for group, keys in groups.items():
                if group in skip:
                    continue
                if all(k in donor and donor[k].shape == own[k].shape
                       for k in keys):
                    graft.update({k: donor[k] for k in keys})
            self.module.load_state_dict(graft, strict=False)
        return self

    def to(self, device):
        """Move the parameters to ``device``."""
        self.device = torch.device(device)
        self.module.to(self.device)
        return self

    def set_dtype(self, dtype):
        """Compute dtype of the forward pass: fp32, or bf16 under
        autocast. The parameters stay fp32 either way."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'compute dtype {dtype} not supported')
        self.dtype = dtype
        return self

    def anchors(self, stride):
        """Cached per-stride anchor table (numpy): [A, 4], or for a
        rotated model the (axis [A, 4], corners [A, 8]) pair."""
        if stride not in self._anchors:
            if self.rotated_bbox:
                table = generate_anchors_rotated(stride, self.ratios,
                                                 self.scales, self.angles)
            else:
                table = generate_anchors(stride, self.ratios, self.scales)
            self._anchors[stride] = table
        return self._anchors[stride]

    def heads(self, images):
        """images [B, H, W, 3] (NHWC, normalized, H and W multiples of
        ``stride``) -> (cls_heads, box_heads): lists of NHWC views of the
        NCHW head outputs, in the compute dtype. Differentiable when
        grad is enabled."""
        x = images.to(self.device).permute(0, 3, 1, 2)
        x = x.to(self.dtype).contiguous()
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            cls_heads, box_heads = self.module(x)
        return ([h.permute(0, 2, 3, 1) for h in cls_heads],
                [h.permute(0, 2, 3, 1) for h in box_heads])

    @torch.inference_mode()
    def forward_heads(self, images):
        """``heads`` for inference, without autograd."""
        return self.heads(images)

    def anchor_tensor(self, stride, device):
        """The per-stride anchor table (or rotated pair) as tensors on
        ``device``, cached (a host copy per step would synchronize the
        stream)."""
        key = (stride, str(device))
        if key not in self._anchor_tensors:
            table = self.anchors(stride)
            self._anchor_tensors[key] = (
                tuple(torch.as_tensor(t, device=device) for t in table)
                if self.rotated_bbox else torch.as_tensor(table,
                                                          device=device))
        return self._anchor_tensors[key]

    def loss_fn(self, images, targets):
        """(cls_loss, box_loss), fp32 scalars on the device, differentiable
        with respect to the parameters (``odtk_tpu/model.py:286-365``).

        images [B, H, W, 3] normalized NHWC; targets [B, max_det, 5]
        (or [B, max_det, 6] rotated) padded with -1. Anchors and
        assignment per FPN level; a rotated model assigns all levels at
        once (``snap_to_anchors_rotated_levels``: one matcher kernel
        launch a step on the card for every group of up to eight levels).
        Then one loss call over all levels, one forward and one backward
        kernel launch a step on the card for every such group (their
        plain versions on the CPU). A model has one level (C4), five (an
        FPN) or five a backbone (several FPNs, strides repeated; the
        anchor tables are shared by stride). Both sums are divided by the
        foreground count, max(fg, 1) per level over the whole batch,
        summed over the levels. In a process group the whole batch is the
        global one, as under the JAX package's mesh: each level's count is
        summed over the processes before it is clamped, and each process
        divides its own sums by that total, so the losses and gradients
        summed over the processes are those of the global batch."""
        cls_heads, box_heads = self.heads(images)
        targets = targets.to(self.device, torch.float32)
        strides = [images.shape[2] // h.shape[2] for h in cls_heads]
        sizes = [(h.shape[2] * s, h.shape[1] * s)
                 for h, s in zip(cls_heads, strides)]
        tables = [self.anchor_tensor(s, self.device) for s in strides]
        if self.rotated_bbox:
            cls_ts, box_ts, depths = snap_to_anchors_rotated_levels(
                targets, sizes, strides, tables, self.classes,
                self.anchor_ious)
        else:
            levels = [snap_to_anchors(targets, size, stride, table,
                                      self.classes, self.anchor_ious)
                      for size, stride, table in zip(sizes, strides, tables)]
            cls_ts, box_ts, depths = (list(parts) for parts in zip(*levels))
        sums = detection_loss_sums_levels(cls_heads, box_heads, cls_ts,
                                          box_ts, depths, self.classes)
        fg = torch.stack([(d > 0).sum() for d in depths])
        if parallel.grouped():
            parallel.all_reduce_sum([fg])
        fg_total = torch.clamp(fg, min=1).sum().float()
        return sums[:, 0].sum() / fg_total, sums[:, 1].sum() / fg_total

    def decode_heads(self, cls_heads, box_heads, width):
        """Decoded candidates of NHWC heads of images ``width`` pixels
        wide, before NMS: (scores [B, N], boxes [B, N, 4] or [B, N, 6]
        rotated, classes [B, N]), N = fused_top_n on the fused path."""
        strides = [width // ch.shape[2] for ch in cls_heads]
        tables = [self.anchors(s) for s in strides]
        if self.rotated_bbox:
            tables = [t[0] for t in tables]       # the axis-aligned half
        if self.decode_fused:
            return decode_fused(cls_heads, box_heads, strides, tables,
                                threshold=self.threshold, top_n=self.top_n,
                                total_top_n=self.fused_top_n,
                                rotated=self.rotated_bbox)
        decoded = [decode(ch, bh, s, t, threshold=self.threshold,
                          top_n=self.top_n, rotated=self.rotated_bbox)
                   for ch, bh, s, t in zip(cls_heads, box_heads, strides,
                                           tables)]
        return tuple(torch.cat(parts, dim=1) for parts in zip(*decoded))

    def postprocess(self, cls_heads, box_heads, width):
        """``decode_heads`` then NMS (the rotated NMS for a rotated model):
        (scores [B, D], boxes [B, D, 4 or 6], classes [B, D]). Traceable by
        ``torch.export`` (``export.py``)."""
        nms_fn = nms_rotated if self.rotated_bbox else nms
        return nms_fn(*self.decode_heads(cls_heads, box_heads, width),
                      self.nms, self.detections)

    @torch.inference_mode()
    def candidates(self, images):
        """Decoded candidates before NMS of NHWC images (``decode_heads``)."""
        cls_heads, box_heads = self.forward_heads(images)
        return self.decode_heads(cls_heads, box_heads, images.shape[2])

    @torch.inference_mode()
    def inference_fn(self, images):
        """Full post-processed inference on NHWC images:
        (scores [B, D], boxes [B, D, 4], classes [B, D]), score-descending
        and zero-padded; rotated boxes are [B, D, 6] (x1, y1, x2, y2,
        sin, cos), through the rotated NMS."""
        return self.postprocess(*self.forward_heads(images), images.shape[2])

    @torch.inference_mode()
    def inference_fn_u8(self, images_u8, sizes):
        """``inference_fn`` on the u8 eval feed: u8 [B, H, W, 3] pixels
        and valid (h, w) ``sizes`` [B, 2]; the normalization runs on the
        device."""
        images_u8 = images_u8.to(self.device)
        return self.inference_fn(eval_normalize_u8(images_u8, sizes))

    def save(self, state):
        from .io import checkpoint
        checkpoint.save(self, state)

    def export(self, size, dynamic_batch_opts=None, precision='bf16',
               calibration_files=None, calibration_table=None,
               verbose=False, path=None, calibration_percentile=None,
               calibration_entropy=False):
        """Export to an inference engine on the model's device
        (``export.export_model``)."""
        from . import export as export_mod
        return export_mod.export_model(
            self, size, precision=precision, path=path,
            dynamic_batch_opts=dynamic_batch_opts,
            calibration_files=calibration_files,
            calibration_table=calibration_table,
            calibration_percentile=calibration_percentile,
            calibration_entropy=calibration_entropy, verbose=verbose)

    @classmethod
    def load(cls, filename, device='cpu', rotated_bbox=False):
        from .io import checkpoint
        return checkpoint.load(filename, device=device,
                               rotated_bbox=rotated_bbox)
