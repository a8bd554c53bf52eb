#!/usr/bin/env python3
"""odtk-tpu-torch CLI: train, infer, export.

Flag-compatible with ``odtk-tpu train``, ``infer`` and ``export``
(``odtk_tpu/main.py``), axis-aligned or rotated (``--rotated-bbox``; a
checkpoint with ``angles``, or a rotated engine, implies it), plus
``--device`` (default ``cuda``). With ``cuda`` and no card it raises;
``--device cpu`` runs the plain PyTorch versions of the kernels on the
CPU. Checkpoints are ``.pth`` / ``.torch`` or ``.ckpt`` (flax msgpack),
as in the JAX CLI (``io/checkpoint.py``). ``export`` writes an engine
(``export.py``) for the device it runs on: a ``.engine`` / ``.plan``
package, a ``.pt2`` program (the JAX CLI's ``.stablehlo``), or a
``.cppengine`` for the C++ samples (``extras/cppapi``); ``infer`` on a
path with an engine extension (``.engine`` / ``.plan``) loads one.
``train`` takes every flag of the JAX CLI: ``--backbone-weights``
(torchvision-format files for a fresh model's backbones), ``--logdir``
(TensorBoard scalars), ``--profile-dir`` (a ``torch.profiler`` trace)
and ``--post-metrics``. A fresh model's backbones start from their
ImageNet weights (``io/model_zoo.py``) unless ``--backbone-weights``,
``--fine-tune`` or ``--no-pretrained`` says otherwise, in the JAX CLI's
order. ``--feed`` takes the JAX CLI's three feeds, with ``u8`` as the
last fallback where the JAX CLI has ``yuv420``. ``--with-dali`` and
``--with-apex`` are compatibility no-ops, as in the JAX CLI. So are
``--fused-stem / --no-fused-stem`` and ``--wpack-layer1 /
--no-wpack-layer1``: in the JAX CLI they pick between two TPU layouts of
the same function, and here the ResNet stem always runs its CUDA kernel
and layer1 as it is.

``train`` and ``infer`` run data parallel (``parallel/``) with
``--num-hosts`` n > 1 or with several cards: each host runs one process
a card (one a host with ``--device cpu``), spawned as the original's
``main.py:244-250`` spawns them, in one group served at ``--master``.
``--host-id`` numbers the hosts, and ``--batch`` is the global batch.
At world 1 nothing is spawned and no group is made; ``export`` always
runs at world 1.
"""

import argparse
import os
import random
import sys

CHECKPOINT_EXTS = ('.pth', '.torch', '.ckpt')
ENGINE_EXTS = ('.engine', '.plan')


def _add_common(parser):
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to run on (default cuda; cpu '
                             'runs the plain versions of the kernels)')
    parser.add_argument('--with-dali', help='(compat no-op: the threaded '
                        'host loader is always on)', action='store_true')
    parser.add_argument('--with-apex', help='(compat no-op: bf16 mixed '
                        'precision is the default)', action='store_true')


def _add_stem_flags(parser):
    """The JAX CLI's two layout switches (``odtk_tpu/main.py:276-290``)."""
    parser.add_argument('--fused-stem', action=argparse.BooleanOptionalAction,
                        default=None, dest='fused_stem',
                        help='(compat no-op: the ResNet stem\'s BN + ReLU + '
                             'max-pool always runs its CUDA kernel, which '
                             'computes the same function)')
    parser.add_argument('--wpack-layer1',
                        action=argparse.BooleanOptionalAction, default=None,
                        dest='wpack_layer1',
                        help='(compat no-op: width-pair packing is a TPU '
                             'layout; layer1 runs as it is)')


def parse(args):
    import torch

    from . import backbones

    parser = argparse.ArgumentParser(
        description='ODTK-TPU (PyTorch + CUDA port): RetinaNet training '
                    'and inference.')
    parser.add_argument('--master', metavar='address:port', type=str,
                        help='endpoint of the process group (served by '
                             'host 0) for data-parallel runs',
                        default='127.0.0.1:29500')
    parser.add_argument('--num-hosts', metavar='n', type=int, default=1,
                        help='number of hosts, each running one process a '
                             'card (one with --device cpu)')
    parser.add_argument('--host-id', metavar='i', type=int, default=0,
                        help='this host\'s index, 0 to n - 1')
    subparsers = parser.add_subparsers(help='sub-command', dest='command')
    subparsers.required = True
    devcount = max(1, torch.cuda.device_count())

    pt = subparsers.add_parser('train', help='train a network')
    pt.add_argument('model', type=str,
                    help='checkpoint to write, .pth or .ckpt (resumes if it '
                         'already exists)')
    pt.add_argument('--annotations', metavar='path', type=str, required=True,
                    help='COCO-JSON annotation file for the training images')
    pt.add_argument('--images', metavar='path', type=str, default='.',
                    help='directory containing the training images')
    names = backbones.available()
    pt.add_argument('--backbone', action='store', type=str, nargs='+',
                    default=['ResNet50FPN'], choices=names, metavar='name',
                    help='one or more backbone names from the registry '
                         f'({", ".join(names)}); several build one model '
                         'whose heads run on the levels of each in turn')
    pt.add_argument('--classes', metavar='num', type=int, default=80,
                    help='object classes in the dataset')
    pt.add_argument('--batch', metavar='size', type=int, default=2 * devcount,
                    help='batch size')
    pt.add_argument('--resize', metavar='scale', type=int, default=800,
                    help='target shorter-side length in pixels')
    pt.add_argument('--max-size', metavar='max', type=int, default=1333,
                    help='cap on the longer side after resizing')
    pt.add_argument('--jitter', metavar='min max', type=int, nargs=2,
                    default=[640, 1024],
                    help='randomize the shorter side within this range')
    pt.add_argument('--iters', metavar='number', type=int, default=90000,
                    help='total optimizer steps')
    pt.add_argument('--milestones', action='store', type=int, nargs='*',
                    default=[60000, 80000],
                    help='steps at which the learning rate is multiplied by '
                         'gamma')
    pt.add_argument('--schedule', metavar='scale', type=float, default=1,
                    help='stretch/shrink factor applied to iters and '
                         'milestones')
    pt.add_argument('--full-precision', action='store_true',
                    help='disable bf16 mixed precision')
    pt.add_argument('--lr', metavar='value', type=float, default=0.01,
                    help='base SGD learning rate')
    pt.add_argument('--warmup', metavar='iterations', type=int, default=1000,
                    help='steps of linear learning-rate ramp-up')
    pt.add_argument('--gamma', metavar='value', type=float, default=0.1,
                    help='learning-rate multiplier at each milestone')
    pt.add_argument('--override', action='store_true',
                    help='start fresh even if the checkpoint file exists')
    pt.add_argument('--val-annotations', metavar='path', type=str,
                    help='COCO-JSON annotations for periodic validation')
    pt.add_argument('--val-images', metavar='path', type=str,
                    help='directory with validation images')
    pt.add_argument('--val-iters', metavar='number', type=int, default=8000,
                    help='run validation every this many steps')
    pt.add_argument('--fine-tune', metavar='path', type=str,
                    help='checkpoint to warm-start from (final class conv '
                         're-initialized)')
    pt.add_argument('--no-pretrained', action='store_true',
                    help='skip the default ImageNet backbone init '
                         '(fetch-with-cache; the reference loads model-zoo '
                         'weights on every fresh model)')
    pt.add_argument('--feed', choices=['yuv420', 'u8', 'f32'], default=None,
                    help='host->device training feed: u8 (3 B/px, raw '
                         'pixels, colour affine on the device), yuv420 '
                         '(1.5 B/px, the JPEG\'s own chroma subsampling, '
                         'lossy; the JAX CLI\'s default) or f32 (host-side '
                         'normalize). ODTK_FEED env is the fallback, then '
                         'u8.')
    pt.add_argument('--augment-rotate', action='store_true',
                    help='randomly rotate images by multiples of 90 degrees')
    pt.add_argument('--augment-free-rotate', metavar='value value',
                    type=float, nargs=2, default=[0, 0],
                    help='(compat no-op: the reference never feeds it to '
                         'training)')
    pt.add_argument('--augment-crop', action='store_true',
                    help='random IoU-constrained crops before resizing')
    pt.add_argument('--augment-brightness', metavar='value', type=float,
                    default=0.002,
                    help='stddev of the random brightness shift')
    pt.add_argument('--augment-contrast', metavar='value', type=float,
                    default=0.002, help='stddev of the random contrast factor')
    pt.add_argument('--augment-hue', metavar='value', type=float,
                    default=0.0002, help='stddev of the random hue rotation')
    pt.add_argument('--augment-saturation', metavar='value', type=float,
                    default=0.002,
                    help='stddev of the random saturation factor')
    pt.add_argument('--regularization-l2', metavar='value', type=float,
                    default=0.0001, help='weight decay coefficient')
    pt.add_argument('--clip-grads', metavar='norm', type=float, default=0.0,
                    help='clip gradients to this global norm (0 disables)')
    pt.add_argument('--anchor-ious', metavar='value value', type=float,
                    nargs=2, default=[0.4, 0.5],
                    help='background / foreground IoU cutoffs for anchor '
                         'assignment')
    pt.add_argument('--anchor-ratios', metavar='value', type=float,
                    nargs='+', default=[1.0, 2.0, 0.5],
                    help='anchor aspect ratios per cell')
    pt.add_argument('--anchor-scales', metavar='value', type=float,
                    nargs='+', default=[4 * 2 ** (i / 3) for i in range(3)],
                    help='anchor scales per cell (in strides)')
    pt.add_argument('--max-det', metavar='num', type=int, default=128,
                    help='static per-image target capacity')
    pt.add_argument('--rotated-bbox', action='store_true',
                    help='train with rotated boxes (x, y, w, h, theta)')
    pt.add_argument('--absolute-angle', action='store_true',
                    help='use the full angle range instead of folding into '
                         '[-45, 45] degrees')
    pt.add_argument('--anchor-angles', metavar='value', type=float,
                    nargs='+', default=None,
                    help='anchor angles in radians (rotated-bbox models '
                         'only)')
    pt.add_argument('--backbone-weights', metavar='path', type=str,
                    nargs='+', default=[],
                    help='torchvision-format state_dict file(s) to '
                         'initialize a fresh model\'s backbone(s) from, '
                         'one per --backbone (in place of the default '
                         'ImageNet init)')
    pt.add_argument('--logdir', metavar='logdir', type=str,
                    help='TensorBoard output directory')
    pt.add_argument('--post-metrics', metavar='url', type=str,
                    help='HTTP endpoint to push training metrics to')
    pt.add_argument('--profile-dir', metavar='path', type=str,
                    help='write a torch.profiler trace of iterations start '
                         '+ 10 to start + 20 to this directory')
    _add_common(pt)
    _add_stem_flags(pt)

    pi = subparsers.add_parser('infer', help='run inference')
    pi.add_argument('model', type=str,
                    help='checkpoint (.pth, .ckpt) or engine (.engine, '
                         '.plan) to run')
    pi.add_argument('--images', metavar='path', type=str, default='.',
                    help='directory of images to process')
    pi.add_argument('--annotations', metavar='annotations', type=str,
                    help='COCO-JSON ground truth; enables mAP scoring')
    pi.add_argument('--output', metavar='file', type=str, nargs='+',
                    default=['detections.json'],
                    help='where to write the detection JSON output')
    pi.add_argument('--batch', metavar='size', type=int, default=2 * devcount,
                    help='images per forward pass')
    pi.add_argument('--resize', metavar='scale', type=int, default=800,
                    help='target shorter-side length in pixels')
    pi.add_argument('--max-size', metavar='max', type=int, default=1333,
                    help='cap on the longer side after resizing')
    pi.add_argument('--full-precision', action='store_true',
                    help='disable bf16 mixed precision')
    pi.add_argument('--rotated-bbox', action='store_true',
                    help='model predicts rotated boxes')
    pi.add_argument('--threshold', metavar='value', type=float, default=None,
                    help='score threshold')
    pi.add_argument('--detections', metavar='num', type=int, default=None,
                    help='max detections per image')
    pi.add_argument('--fixed-size', metavar='height width', type=int,
                    nargs='+', default=None,
                    help='letterbox inputs to a fixed canvas: one value for '
                         'square, or height width')
    _add_common(pi)
    _add_stem_flags(pi)

    pe = subparsers.add_parser('export', help='export a model into an '
                               'inference engine')
    pe.add_argument('model', type=str, help='checkpoint to export')
    pe.add_argument('export', type=str,
                    help='path of the engine to write (.engine or .plan '
                         'package, .pt2 program, or .cppengine for the C++ '
                         'samples)')
    pe.add_argument('--size', metavar='height width', type=int, nargs='+',
                    default=[1280], help='fixed engine input: one value for '
                                         'square, or height width')
    pe.add_argument('--full-precision', action='store_true',
                    help='keep fp32 compute instead of bf16')
    pe.add_argument('--input-format', choices=['f32', 'u8'], default='f32',
                    dest='input_format',
                    help='.cppengine input contract: u8 takes raw '
                         'letterboxed RGB bytes and normalizes in-graph (4x '
                         'fewer host->device bytes per frame)')
    pe.add_argument('--int8', action='store_true',
                    help='run INT8 calibration and emit an int8 engine')
    pe.add_argument('--calibration-batches', metavar='size', type=int,
                    default=2, help='how many calibration batches to sample')
    pe.add_argument('--calibration-images', metavar='path', type=str,
                    default='', help='directory of images for INT8 '
                                     'calibration')
    pe.add_argument('--calibration-table', metavar='path', type=str,
                    default='', help='calibration table to reuse (or '
                                     'filename to create)')
    pe.add_argument('--calibration-percentile', metavar='value', type=float,
                    default=None,
                    help='clip activation ranges at this percentile of '
                         '|input| (e.g. 99.9) instead of absmax')
    pe.add_argument('--calibration-entropy', action='store_true',
                    help='pick each layer\'s INT8 clipping threshold by '
                         'KL-divergence over activation histograms (the '
                         'TensorRT IInt8EntropyCalibrator2 rule)')
    pe.add_argument('--verbose', action='store_true',
                    help='print export progress')
    pe.add_argument('--rotated-bbox', action='store_true',
                    help='model predicts rotated boxes')
    pe.add_argument('--dynamic-batch-opts', metavar='value value value',
                    type=int, nargs=3, default=[1, 8, 16],
                    help='export these batch-size profiles (min, opt, max)')
    # post-processing settings baked into the engine
    pe.add_argument('--threshold', metavar='value', type=float, default=None,
                    help='score threshold baked into decode')
    pe.add_argument('--top-n', metavar='num', type=int, default=None,
                    help='per-image candidate budget before NMS')
    pe.add_argument('--nms', metavar='value', type=float, default=None,
                    help='NMS IoU threshold')
    pe.add_argument('--detections', metavar='num', type=int, default=None,
                    help='max detections emitted per image')
    _add_common(pe)
    _add_stem_flags(pe)
    return parser.parse_args(args)


def load_model(args):
    """(Model, resume state): a fresh model for ``train`` without a
    checkpoint (or with ``--override``), an ``Engine`` for ``infer`` on an
    engine file, else the checkpoint's. A fresh model is filled on the
    CPU: from ``--backbone-weights`` where given, else, without
    ``--fine-tune`` and ``--no-pretrained``, from the ImageNet files
    (``io/model_zoo.init_pretrained``), as ``odtk_tpu/main.py:322-332``
    does."""
    from .model import Model

    ext = os.path.splitext(args.model)[1]
    if args.command == 'infer' and ext in ENGINE_EXTS:
        from .export import Engine
        print('Loading engine from {}...'.format(os.path.basename(args.model)))
        return Engine.load(args.model, device=args.device), {}
    if args.command == 'train' and (args.override
                                    or not os.path.exists(args.model)):
        print('Initializing model...')
        model = Model(backbones=args.backbone, classes=args.classes,
                      ratios=args.anchor_ratios, scales=args.anchor_scales,
                      angles=args.anchor_angles,
                      rotated_bbox=args.rotated_bbox,
                      anchor_ious=args.anchor_ious)
        model.initialize(random.randint(0, 2 ** 31 - 1),
                         fine_tune=args.fine_tune)
        if args.backbone_weights:
            from .io.torch_import import load_backbone_weights
            for name, path in zip(args.backbone, args.backbone_weights):
                print('Loading {} weights from {}...'.format(name, path))
                load_backbone_weights(model, name, path)
        elif args.fine_tune is None and not args.no_pretrained:
            # the original's default: every fresh backbone gets ImageNet
            # weights; warns loudly and trains from scratch when they
            # cannot be had
            from .io.model_zoo import init_pretrained
            init_pretrained(model)
        state = {}
    else:
        if ext not in CHECKPOINT_EXTS:
            raise RuntimeError('Invalid model format "{}"!'.format(ext))
        # loaded on the CPU: train() / infer() move it to the device
        print('Loading model from {}...'.format(os.path.basename(args.model)))
        model, state = Model.load(args.model,
                                  rotated_bbox=args.rotated_bbox)
    print(model)
    state['path'] = args.model
    return model, state


def run(args, model, state):
    from . import infer as infer_mod
    from . import train as train_mod

    if model.rotated_bbox:
        args.rotated_bbox = True
    if args.fused_stem is not None:
        print('--fused-stem ignored: the ResNet stem always runs its CUDA '
              'kernel, which computes the same function')
    if args.wpack_layer1 is not None:
        print('--wpack-layer1 ignored: width-pair packing is a TPU layout; '
              'layer1 runs as it is')
    if args.with_apex:
        print('--with-apex ignored: bf16 mixed precision is the default '
              '(use --full-precision for fp32)')
    if args.command == 'train':
        if any(args.augment_free_rotate):
            print('--augment-free-rotate ignored: the reference defines this '
                  'flag but never feeds it to training')
        return train_mod.train(
            model, state, args.images, args.annotations,
            args.val_images or args.images, args.val_annotations,
            args.resize, args.max_size, args.jitter, args.batch,
            int(args.iters * args.schedule), args.val_iters, args.lr,
            args.warmup, [int(m * args.schedule) for m in args.milestones],
            args.gamma, mixed_precision=not args.full_precision, verbose=True,
            metrics_url=args.post_metrics, logdir=args.logdir,
            profile_dir=args.profile_dir, rotate_augment=args.augment_rotate,
            crop_augment=args.augment_crop,
            augment_brightness=args.augment_brightness,
            augment_contrast=args.augment_contrast,
            augment_hue=args.augment_hue,
            augment_saturation=args.augment_saturation,
            regularization_l2=args.regularization_l2, max_det=args.max_det,
            clip_grads=args.clip_grads, feed=args.feed, device=args.device,
            rotated_bbox=args.rotated_bbox,
            absolute_angle=args.absolute_angle)

    if args.command == 'export':
        return export(args, model)

    if not hasattr(model, 'input_size'):           # not an engine
        if args.threshold is not None:
            model.threshold = args.threshold
        if args.detections is not None:
            model.detections = args.detections
    fixed_size = args.fixed_size
    if fixed_size is not None:
        fixed_size = tuple(fixed_size * 2 if len(fixed_size) == 1
                           else fixed_size[:2])
    return infer_mod.infer(
        model, args.images, args.output, args.resize, args.max_size,
        args.batch, annotations=args.annotations,
        mixed_precision=not args.full_precision, verbose=True,
        fixed_size=fixed_size, device=args.device,
        rotated_bbox=args.rotated_bbox)


def _find_calibration_images(directory, want, minimum):
    """Sample ``want`` JPEG/PNG files from a directory for INT8
    calibration; error below ``minimum`` (cannot fill one opt batch)."""
    found = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.lower().endswith(('.jpg', '.jpeg', '.png')))
    if len(found) < minimum:
        raise RuntimeError(
            'Not enough images found for calibration. ({} < {})'.format(
                len(found), minimum))
    random.shuffle(found)
    return found[:want]


def export(args, model):
    """The ``export`` command (``odtk_tpu/main.py:435-471``): the
    post-processing overrides baked in, calibration images sampled for
    INT8, the engine exported on ``--device``; a ``.cppengine`` at the
    batch of ``--dynamic-batch-opts``' middle value, in the contract of
    ``--input-format``."""
    import torch

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but no CUDA device is '
                           'available (pass --device cpu to export for the '
                           'CPU)')
    model.to(device)
    input_size = args.size * 2 if len(args.size) == 1 else args.size[:2]
    for flag in ('threshold', 'top_n', 'nms', 'detections'):
        value = getattr(args, flag)
        if value is not None:
            setattr(model, flag, value)
    if args.top_n is not None:
        model.fused_top_n = 2 * model.top_n     # keeps the derived default

    calibration_files = []
    if args.int8 and os.path.isdir(args.calibration_images):
        calibration_files = _find_calibration_images(
            args.calibration_images,
            want=args.calibration_batches * args.dynamic_batch_opts[1],
            minimum=args.dynamic_batch_opts[1])
    precision = 'FP32' if args.full_precision else 'FP16'
    if args.int8:
        precision = 'INT8'
    if args.export.endswith('.cppengine'):
        # self-contained C++ deployment engine (extras/cppapi)
        from .export import export_cpp_engine
        return export_cpp_engine(model, tuple(input_size),
                                 batch=args.dynamic_batch_opts[1],
                                 path=args.export, precision=precision,
                                 input_format=args.input_format,
                                 verbose=args.verbose)
    return model.export(input_size, args.dynamic_batch_opts, precision,
                        calibration_files, args.calibration_table,
                        args.verbose, path=args.export,
                        calibration_percentile=args.calibration_percentile,
                        calibration_entropy=args.calibration_entropy)


def local_devices(device):
    """The cards a host spreads a run over: all of them for a bare
    ``cuda``, else the one device named."""
    import torch

    return max(1, torch.cuda.device_count()) if device == 'cuda' else 1


def local_processes(args):
    """Processes this host runs: one a card that takes part (``parallel.
    processes_for_batch``), after the batch guards; 1 for ``export``."""
    from . import parallel

    if args.command == 'export':
        return 1
    devices = local_devices(args.device)
    local_batch = parallel.host_local_batch_size(args.batch, args.num_hosts,
                                                 devices)
    return parallel.processes_for_batch(local_batch, devices, args.num_hosts)


def worker(local_rank, args, local):
    """One rank of a data-parallel run: joins the group, runs on its own
    card (``cuda:<local_rank>``), leaves the group."""
    import torch.distributed as dist

    from . import parallel

    parallel.init_distributed(args.master, args.num_hosts, args.host_id,
                              args.device, local_rank, local)
    if args.device == 'cuda':
        args.device = f'cuda:{local_rank}'
    try:
        model, state = load_model(args)
        return run(args, model, state)
    finally:
        dist.destroy_process_group()


def main(args=None):
    'Entry point for the odtk-tpu-torch command'
    args = parse(sys.argv[1:] if args is None else args)
    local = local_processes(args)
    if args.command == 'export' or args.num_hosts * local == 1:
        model, state = load_model(args)
        return run(args, model, state)
    if local == 1:
        return worker(0, args, 1)
    import torch.multiprocessing

    torch.multiprocessing.spawn(worker, args=(args, local), nprocs=local)


if __name__ == '__main__':
    main()
