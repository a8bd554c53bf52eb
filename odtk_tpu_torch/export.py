"""Deployment export: inference engines with decode and NMS inside.

Counterpart of ``odtk_tpu/export.py`` (the JAX package's replacement of
the original ONNX -> TensorRT flow). ``export_model`` traces the whole
post-processed inference (NHWC normalized f32 images -> heads ->
``decode_fused`` -> NMS, or rotated NMS for a rotated model) with
``torch.export.export``, one program per batch profile, and packs the
programs with the weights and metadata into ONE engine file. The
hand-written kernels stay in the programs as the ``odtk::nms``,
``odtk::nms_rotated`` and ``odtk::bn_relu_pool`` operators
(``ops/kernels/``), and ``odtk::conv_w8a8`` in a w8a8 model's: on the
card they launch the kernels, on the CPU their plain versions. Importing
this module registers them, which ``torch.export.load`` needs.

Precision: ``FP32``/``fp32``, ``FP16``/``bf16`` (bf16 compute), ``INT8``
(w8a16: int8 per-channel convolution weights dequantized in the graph,
bf16 activations; ``calibrate`` fixes which layers). A model whose module
``quantize.build_quant_variables(..., mode='w8a8')`` already swapped
exports at ``bf16`` or ``fp32`` with its int8 convolutions and activation
scales, as the JAX ``export_model`` does over w8a8 variables. A bf16 engine
computes under ``torch.autocast`` as the checkpoint path does
(``Model.heads``), which ``torch.export`` keeps as a ``wrap_with_autocast``
region: autocast also runs the FPN's nearest upsampling in fp32, so the
top-down sums round once, and casting the ops by hand instead changed the
heads by a bf16 ulp (NVIDIA H100, torch 2.11). Its convolution weights
are stored in bf16, the dtype autocast casts them to.

Two more targets hold their weights inside one file: ``.pt2``
(``export_model``), the ``torch.export.save`` program of the largest
batch profile on the ``.engine``'s input, in place of the JAX package's
``.stablehlo`` (XLA's format, which has no writer here: that path is
refused); and ``.cppengine`` (``export_cpp_engine``), an AOTInductor
package compiled for the device, which the C++ samples in
``extras/cppapi`` load without Python.

In a ``.engine`` the weights are an input of each program, not part of
it, so the programs of all batch profiles share one copy in the file (as
the JAX package's engine keeps its variables beside its executables). An
engine runs on the device type it was exported on; ``Engine.load``
refuses another. File layout: ``ENGINE_HEADER``, then little-endian u64 lengths
each followed by its bytes: the JSON metadata, the weights
(``torch.save`` of a state_dict), the calibration table (JSON, or empty),
then one ``torch.export.save`` program per batch profile, in the order of
``meta['batches']``.
"""

import contextlib
import io
import json
import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np
import torch
from torch import nn

from .data.coco import IMAGENET_MEAN, IMAGENET_STD
# the odtk:: operators an engine's programs call
from .ops.kernels import conv_w8a8 as _conv_w8a8  # noqa: F401
from .ops.kernels import nms as _nms  # noqa: F401
from .ops.kernels import nms_rotated as _nms_rotated  # noqa: F401
from .ops.kernels import stem as _stem  # noqa: F401

ENGINE_MAGIC = 'odtk-tpu-torch-engine-v1'
ENGINE_HEADER = b'ODTK-TORCH-ENGINE\n'


def _dtype_of(precision):
    if precision in ('fp32', 'FP32'):
        return torch.float32
    if precision in ('bf16', 'FP16', 'int8', 'INT8'):
        return torch.bfloat16
    raise ValueError(f'unknown precision {precision!r}')


class EngineNet(nn.Module):
    """The traced function: (variables, images [B, H, W, 3] f32 NHWC
    normalized) -> (scores [B, D], boxes [B, D, 4 or 6], classes [B, D]),
    the checkpoint path's ``Model.heads`` and ``Model.postprocess``, with
    the model's post-processing settings read at trace time.
    ``variables`` is the state_dict of ``net`` (the checkpoint's module with
    its convolution weights in the compute dtype, or int8), passed in by
    ``torch.func.functional_call``: ``net`` is kept out of this module's
    own state so the traced program holds no weights."""

    def __init__(self, model, net, dtype):
        super().__init__()
        object.__setattr__(self, 'net', net)
        self.model = model
        self.dtype = dtype

    def forward(self, variables, images):
        x = images.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        if self.dtype == torch.float32:
            compute = contextlib.nullcontext()
        else:
            compute = torch.autocast(images.device.type, dtype=self.dtype)
        with compute:
            cls_heads, box_heads = torch.func.functional_call(
                self.net, variables, (x,))
        cls_heads = [h.permute(0, 2, 3, 1) for h in cls_heads]
        box_heads = [h.permute(0, 2, 3, 1) for h in box_heads]
        return self.model.postprocess(cls_heads, box_heads, images.shape[2])


def engine_net(model, dtype, quantized=None):
    """(EngineNet, variables) for ``model`` in ``dtype``: a copy of the
    module on the model's device with every convolution's weight and bias
    stored in ``dtype`` (autocast's cast, done once); ``quantized``: the
    copy already swapped to ``QuantConv2d``s
    (``quantize.build_quant_variables``)."""
    import copy

    net = quantized if quantized is not None else copy.deepcopy(model.module)
    net = net.to(model.device).eval()
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.to(dtype)
            if m.bias is not None:
                m.bias.data = m.bias.data.to(dtype)
    variables = {k: v.detach() for k, v in net.state_dict().items()}
    return EngineNet(model, net, dtype), variables


# the u8 contract's normalization, (x / 255 - mean) / std, as a
# subtraction and a multiplication
U8_SHIFT = np.float32(255.0) * IMAGENET_MEAN
U8_SCALE = np.float32(1.0) / (np.float32(255.0) * IMAGENET_STD)


def normalize_u8(images):
    """Raw RGB u8 [B, H, W, 3] -> normalized f32, the JAX package's C++
    engine's ``(x / 255 - mean) / std`` with no pad mask
    (``odtk_tpu/export.py:export_cpp_engine``), computed as ``(x - 255
    mean) * (1 / (255 std))``: a compiled graph turns a division by a
    constant into a multiplication by its reciprocal and may fuse a
    multiply and an add, so this is the form that it and eager round
    alike."""
    shift = torch.from_numpy(U8_SHIFT).to(images.device)
    scale = torch.from_numpy(U8_SCALE).to(images.device)
    return (images.float() - shift) * scale


class PackagedNet(nn.Module):
    """An ``EngineNet`` whose weights are its own module state, so that one
    file holds the program and its weights (``.pt2``, ``.cppengine``):
    images [B, H, W, 3] -> the engine's (scores, boxes, classes).
    ``input_format`` 'u8' takes raw RGB bytes and normalizes them in the
    graph (``normalize_u8``); ``flat_boxes`` returns boxes as
    [B, D * box_dim], the JAX C++ engine's rank-2 layout."""

    def __init__(self, engine, input_format='f32', flat_boxes=False):
        super().__init__()
        if input_format not in ('f32', 'u8'):
            raise ValueError(f'unknown input format {input_format!r} '
                             '(f32 or u8)')
        self.engine = engine
        self.net = engine.net
        self.u8 = input_format == 'u8'
        self.flat_boxes = flat_boxes

    def forward(self, images):
        if self.u8:
            images = normalize_u8(images)
        # no variables given: ``functional_call`` runs on the net's own
        scores, boxes, classes = self.engine({}, images)
        if self.flat_boxes:
            boxes = boxes.reshape(boxes.shape[0], -1)
        return scores, boxes, classes


def _round_size(model, size):
    if isinstance(size, int):
        size = (size, size)
    if len(size) == 1:
        size = (size[0], size[0])
    # the loader pads every image up to a multiple of the stride, so an
    # unaligned engine would reject its own loader's batches
    aligned = tuple(-(-s // model.stride) * model.stride for s in size)
    if aligned != tuple(size):
        print(f'rounding engine size {tuple(size)} up to stride-aligned '
              f'{aligned} (model stride {model.stride})')
    return aligned


def export_model(model, size, batch=1, precision='bf16', path=None,
                 dynamic_batch_opts=None, calibration_files=None,
                 calibration_table=None, calibration_percentile=None,
                 calibration_entropy=False, verbose=False):
    """Export a Model to an Engine on the model's device (``model.to``
    first), written to ``path`` when given. size: (H, W), rounded up to
    the stride. dynamic_batch_opts: (min, opt, max) batch profiles, one
    program each. INT8 calibrates (or reads ``calibration_table``) and
    stores the calibrated convolutions as int8."""
    if path and path.endswith('.stablehlo'):
        raise ValueError(
            '.stablehlo is XLA\'s interchange format and has no writer on '
            'this package\'s devices: write a .pt2 (the torch.export '
            'program of the largest batch profile) instead')
    size = _round_size(model, size)
    dtype = _dtype_of(precision)
    model.set_dtype(dtype)

    scale_table, quantized = None, None
    if precision in ('int8', 'INT8'):
        import copy
        from .quantize import build_quant_variables

        scale_table = calibrate(model, size, calibration_files,
                                calibration_table,
                                percentile=calibration_percentile,
                                entropy=calibration_entropy, verbose=verbose)
        quantized, qstats = build_quant_variables(
            copy.deepcopy(model.module), scale_table['act_absmax'])
        if verbose:
            print('int8: {} conv kernels stored as int8 ({:.2f}x smaller '
                  'weights), computed in bf16 (w8a16)'.format(
                      qstats['quantized_tensors'], qstats['ratio']))

    net, variables = engine_net(model, dtype, quantized)
    batches = sorted(set(dynamic_batch_opts or [batch]))
    if path and path.endswith('.pt2'):
        images = torch.zeros(batches[-1], size[0], size[1], 3,
                             device=model.device)
        with torch.no_grad():
            program = torch.export.export(PackagedNet(net), (images,))
        program.example_inputs = None
        torch.export.save(program, path)
        if verbose:
            print(f'Wrote {path} (batch {batches[-1]}, {size[0]}x{size[1]}, '
                  f'{os.path.getsize(path) / 1e6:.1f} MB)')
        return path
    meta = {
        'magic': ENGINE_MAGIC,
        'input_size': list(size),
        'batches': batches,
        'precision': precision,
        'stride': model.stride,
        'rotated': model.rotated_bbox,
        'detections': model.detections,
        'classes': model.classes,
        'backbones': model.backbones,
        'device': model.device.type,
        'postprocessing': {'threshold': model.threshold,
                           'top_n': model.top_n, 'nms': model.nms,
                           'fused_top_n': model.fused_top_n,
                           'decode_fused': model.decode_fused},
        'preprocessing': {'mean': IMAGENET_MEAN.tolist(),
                          'std': IMAGENET_STD.tolist(),
                          'layout': 'NHWC', 'range': '[0,1]'},
        'torch': torch.__version__,
    }
    blobs = {}
    for b in batches:
        if verbose:
            print(f'Exporting batch profile {b}...')
        images = torch.zeros(b, size[0], size[1], 3, device=model.device)
        with torch.no_grad():
            program = torch.export.export(net, (variables, images))
        program.example_inputs = None     # else each program saves the weights
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[str(b)] = buf.getvalue()

    engine = Engine(meta, blobs, variables, scale_table=scale_table)
    if path:
        engine.save(path)
    return engine


def _openmp_compiler():
    """The C++ compiler for AOTInductor: the one it would take (``$CXX``,
    else ``g++``) if that one links OpenMP, which the package's wrapper
    is built with (``-fopenmp``), else the first of ``g++`` and ``c++``
    on the PATH that does; None (AOTInductor's own choice) where none
    does. A GCC links OpenMP where it finds ``libgomp.spec``: a toolchain
    trimmed of it fails at the link."""
    from torch._inductor import config

    for cxx in [c for c in config.cpp.cxx if c] + ['g++', 'c++']:
        path = shutil.which(cxx)
        if path is None:
            continue
        spec = subprocess.run([path, '-print-file-name=libgomp.spec'],
                              capture_output=True, text=True, timeout=60)
        if os.path.isabs(spec.stdout.strip()):
            return path
    return None


def export_cpp_engine(model, size, batch=1, path='model.cppengine',
                      precision='bf16', input_format='f32', verbose=False):
    """Write a self-contained C++ engine (``odtk_tpu_torch/extras/cppapi``),
    the counterpart of ``odtk_tpu/export.py:export_cpp_engine``: an
    AOTInductor package (``torch._inductor.aoti_compile_and_package``)
    compiled for the model's device, with the weights baked in as
    constants, one fixed ``batch`` and the JAX engine's contract: input
    [batch, H, W, 3] f32 normalized NHWC, or raw RGB uint8 with
    ``input_format='u8'`` (normalized in the graph); outputs (scores
    [B, D], boxes [B, D * box_dim], classes [B, D]). The hand-written
    kernels stay ``odtk::`` operators that the compiled code calls: from
    Python the ones ``ops/kernels/`` registers, from C++ the ones
    ``extras/cppapi/odtk_ops.cpp`` registers. The package's metadata
    (``get_metadata()``, strings) holds the JAX container's keys
    (height, width, batch, detections, box_dim, stride, classes,
    backbones, precision, input) and ``device``. Precision: fp32 or bf16
    (under the ``.engine``'s autocast region); INT8 is refused, as no
    quantized C++ engine exists."""
    if precision in ('int8', 'INT8'):
        raise ValueError(
            'INT8 .cppengine: the C++ engine is fp32 or bf16 (a w8a16 '
            'program is the .engine\'s); export without --int8, or write '
            'an INT8 .engine')
    if any(getattr(m, 'act_scale', None) is not None
           for m in model.module.modules()):
        raise ValueError(
            'w8a8 .cppengine: the C++ samples register no int8 convolution '
            '(odtk::conv_w8a8); write a w8a8 model as an .engine')
    size = _round_size(model, size)
    dtype = _dtype_of(precision)
    model.set_dtype(dtype)
    net, _ = engine_net(model, dtype)
    packaged = PackagedNet(net, input_format, flat_boxes=True)
    images = torch.zeros(
        batch, size[0], size[1], 3, device=model.device,
        dtype=torch.uint8 if input_format == 'u8' else torch.float32)
    meta = {
        'height': size[0], 'width': size[1], 'batch': batch,
        'detections': model.detections,
        'box_dim': 6 if model.rotated_bbox else 4,
        'stride': model.stride, 'classes': model.classes,
        'backbones': '+'.join(model.backbones), 'precision': precision,
        'input': input_format, 'device': model.device.type,
    }
    if verbose:
        print(f'Compiling (device={model.device}, batch={batch}, '
              f'size={size})...')
    with torch.no_grad():
        program = torch.export.export(packaged, (images,))
    from torch._inductor import aoti_compile_and_package

    configs = {'aot_inductor.metadata': {k: str(v) for k, v in meta.items()}}
    # the .engine's numbers: bf16 rounded after each fused operation as
    # eager rounds it, and float32 division rounded as eager's (Triton's
    # own is approximate)
    from torch._inductor import config as inductor_config
    if hasattr(inductor_config, 'emulate_precision_casts'):
        configs['emulate_precision_casts'] = True
    if hasattr(getattr(inductor_config, 'eager_numerics', None),
               'division_rounding'):
        configs['eager_numerics.division_rounding'] = True
    cxx = _openmp_compiler()
    if cxx:
        configs['cpp.cxx'] = (cxx,)
    # the packager takes only a .pt2 name, and names the archive's root
    # folder after it
    work = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        tmp = os.path.join(work, os.path.splitext(
            os.path.basename(path))[0] + '.pt2')
        aoti_compile_and_package(program, package_path=tmp,
                                 inductor_configs=configs)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if verbose:
        print(f'Wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)')
    return path


def load_cpp_engine(path):
    """A ``.cppengine`` loaded into this process
    (``torch._inductor.aoti_load_package``): call it on one input batch of
    its contract; ``get_metadata()`` gives its metadata. Its ``odtk::``
    operators are this package's Python registration."""
    from torch._inductor import aoti_load_package

    with open(path, 'rb') as f:       # a file: the loader takes any name
        return aoti_load_package(f)


def calibrate(model, size, calibration_files, calibration_table=None,
              batches=2, percentile=None, entropy=False, verbose=False):
    """INT8 calibration (``odtk_tpu/export.py:calibrate``): per-conv input
    ranges over up to ``batches`` x 8 calibration images, each resized to
    ``size`` by PIL bilinear and normalized, run one at a time through the
    model in its current dtype; persisted as a reusable JSON table, which
    is read back instead when the file exists. absmax (percentile None),
    a percentile of |input| per image max-merged over the set, or
    entropy: 2048-bin histograms over the absmax span summed over the set
    and the KL-minimizing clip per layer."""
    name = '_'.join(model.backbones)
    suffix = '_entropy' if entropy else (
        f'_p{percentile:g}' if percentile is not None else '')
    table_name = (calibration_table or
                  f'Int8CalibrationTable_{name}{size[0]}x{size[1]}'
                  f'_{batches}{suffix}')
    if os.path.isfile(table_name):
        if verbose:
            print(f'Reading calibration table {table_name}')
        with open(table_name) as f:
            return json.load(f)

    from PIL import Image

    from .quantize import (capture_activation_absmax, capture_activation_hist,
                           entropy_thresholds, merge_absmax, merge_hist)
    files = list(calibration_files or [])[:batches * 8]
    if not files:
        raise RuntimeError('No calibration images found')
    arrays, absmax = [], {}
    for fp in files:
        im = Image.open(fp).convert('RGB').resize((size[1], size[0]),
                                                  Image.BILINEAR)
        arr = (np.asarray(im, np.float32) / 255.0 - IMAGENET_MEAN) \
            / IMAGENET_STD
        x = torch.from_numpy(np.ascontiguousarray(arr[None], np.float32))
        arrays.append(x)
        absmax = merge_absmax(absmax, capture_activation_absmax(
            model, x, None if entropy else percentile))
    method = 'absmax' if percentile is None else f'percentile{percentile:g}'
    if entropy:
        hists = {}
        for x in arrays:
            hists = merge_hist(hists, capture_activation_hist(model, x,
                                                              absmax))
        absmax = entropy_thresholds(hists, absmax)
        method = 'entropy'
    table = {'version': 2, 'net': name, 'size': list(size),
             'method': method, 'act_absmax': absmax}
    with open(table_name, 'w') as f:
        json.dump(table, f)
    if verbose:
        print(f'Wrote calibration table {table_name} ({len(absmax)} layers)')
    return table


def _write_chunk(f, data):
    f.write(struct.pack('<Q', len(data)))
    f.write(data)


def _read_chunk(f):
    head = f.read(8)
    if len(head) != 8:
        raise ValueError('truncated engine file')
    (n,) = struct.unpack('<Q', head)
    data = f.read(n)
    if len(data) != n:
        raise ValueError('truncated engine file')
    return data


class Engine:
    """Inference engine (``odtk_tpu.export.Engine``): fixed input size,
    batch profiles, ``__call__`` on [B, H, W, 3] f32 normalized NHWC images
    (a tensor or an array) -> (scores, boxes, classes) tensors on the
    engine's device. A batch is padded up to the nearest profile, and one
    larger than the largest profile runs in profile-sized chunks."""

    def __init__(self, meta, blobs, variables, scale_table=None,
                 device=None):
        self.meta = meta
        self.blobs = blobs
        self.variables = {k: v.detach().cpu() for k, v in variables.items()}
        self.scale_table = scale_table
        self.device = torch.device(device or meta['device'])
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('this engine was exported on CUDA and no CUDA '
                               'device is available: export it again on '
                               'the device it should run on')
        if self.device.type == 'cuda' and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        self._programs = {}
        self._device_variables = None

    # --------------------------------------------------------------- props
    @property
    def input_size(self):
        return tuple(self.meta['input_size'])

    @property
    def stride(self):
        return self.meta['stride']

    @property
    def max_batch(self):
        return max(self.meta['batches'])

    @property
    def max_detections(self):
        return self.meta['detections']

    @property
    def rotated_bbox(self):
        return self.meta['rotated']

    # ----------------------------------------------------------------- io
    def save(self, path):
        weights = io.BytesIO()
        torch.save(self.variables, weights)
        table = (json.dumps(self.scale_table).encode()
                 if self.scale_table is not None else b'')
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            f.write(ENGINE_HEADER)
            _write_chunk(f, json.dumps(self.meta).encode())
            _write_chunk(f, weights.getvalue())
            _write_chunk(f, table)
            for b in self.meta['batches']:
                _write_chunk(f, self.blobs[str(b)])
        os.replace(tmp, path)

    @classmethod
    def load(cls, path, device=None):
        """The engine in ``path``, on ``device`` when given (a card of a
        data-parallel run: its rank's), which must be of the device type
        the engine was exported on."""
        with open(path, 'rb') as f:
            if f.read(len(ENGINE_HEADER)) != ENGINE_HEADER:
                raise ValueError(f'{path} is not an odtk-tpu-torch engine')
            meta = json.loads(_read_chunk(f))
            if meta.get('magic') != ENGINE_MAGIC:
                raise ValueError(f'{path} is not an odtk-tpu-torch engine '
                                 f'({meta.get("magic")!r})')
            if device is not None and torch.device(device).type != \
                    meta['device']:
                raise ValueError(f'{path} was exported on {meta["device"]} '
                                 f'and cannot run on {device}: export it '
                                 'again on that device')
            variables = torch.load(io.BytesIO(_read_chunk(f)),
                                   map_location='cpu', weights_only=True)
            table = _read_chunk(f)
            blobs = {str(b): _read_chunk(f) for b in meta['batches']}
        return cls(meta, blobs, variables,
                   scale_table=json.loads(table) if table else None,
                   device=device)

    # ---------------------------------------------------------------- run
    def program(self, batch):
        """The callable of one batch profile (loaded on first use)."""
        key = str(batch)
        if key not in self._programs:
            exported = torch.export.load(io.BytesIO(self.blobs[key]))
            if self.device.type == 'cuda':
                # the program names the card it was exported on; run it
                # on this engine's
                from torch.export.passes import move_to_device_pass
                exported = move_to_device_pass(
                    exported, {f'cuda:{i}': str(self.device)
                               for i in range(torch.cuda.device_count())})
            self._programs[key] = exported.module()
        return self._programs[key]

    def __call__(self, images):
        images = torch.as_tensor(images, dtype=torch.float32)
        b = images.shape[0]
        profiles = sorted(int(x) for x in self.blobs)
        if b > profiles[-1]:
            step = profiles[-1]
            parts = [self(images[i:i + step]) for i in range(0, b, step)]
            return tuple(torch.cat(p, dim=0) for p in zip(*parts))
        target = next(p for p in profiles if p >= b)
        th, tw = self.input_size
        h, w = min(images.shape[1], th), min(images.shape[2], tw)
        padded = torch.zeros(target, th, tw, 3, device=self.device)
        padded[:b, :h, :w] = images[:, :h, :w].to(self.device)
        if self._device_variables is None:
            # one upload of the weights, not one per call
            self._device_variables = {k: v.to(self.device)
                                      for k, v in self.variables.items()}
        with torch.no_grad():
            out = self.program(target)(self._device_variables, padded)
        return tuple(o[:b] for o in out)
