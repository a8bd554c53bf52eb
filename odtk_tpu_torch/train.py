"""Training workflow: the train step, the learning-rate schedule, the
checkpoint and log cadence, periodic validation.

Counterpart of ``odtk_tpu/train.py``, on one device or, in a process
group (``parallel``), on one device a process:

- SGD with momentum 0.9 (``torch.optim.SGD``, dampening 0, its fused
  form) and L2 weight decay folded into the gradient before the momentum,
  the optax chain's order; ``clip_grads`` clips by global norm before
  that, like ``optax.clip_by_global_norm`` at the head of the chain.
- The warmup + milestone schedule of ``lr_schedule``.
- Mixed precision: bf16 compute under autocast, fp32 parameters, loss
  and optimizer state (``Model.set_dtype``).
- The non-finite step skip: a step whose global gradient norm is not
  finite leaves the parameters and the momentum buffers untouched. The
  flag stays on the device (the fused SGD kernel reads it), so the step
  does not wait for the host. The learning rate follows the iteration
  count; the JAX schedule follows the count of applied updates, which
  is one less after each skipped step.
- Losses are fetched every ``sync_every`` steps, with the divergence
  guard; the checkpoint, the log line, the TensorBoard scalars
  (``logdir``) and the metrics POST (``metrics_url``) come every ~60 s
  and at the end, validation every ``val_iterations``.
- In a group each process trains on its share of the global batch: the
  loss is normalized over the global batch (``Model.loss_fn``), one
  all-reduce a step sums the gradients and the two losses over the
  processes, rank 0's weights are broadcast once at the start, and
  every process skips, clips and logs the same global numbers. The
  divergence guard raises at the same step on every rank; only rank 0
  writes the checkpoint, the scalars, the metrics and the trace, and
  every rank takes part in validation (``infer`` gathers). ``profile_dir``
  takes a ``torch.profiler`` trace of iterations start + 10 to start +
  20, as the JAX trainer takes a ``jax.profiler`` one.
- The checkpoint's optimizer state has its path's format
  (``io/checkpoint.py``): a ``torch.optim`` state_dict in a ``.pth``,
  the JAX trainer's optax state in a ``.ckpt`` (``io/opt_state.py``,
  with the count of applied updates); the momentum is restored from
  either, and from the optax bytes of a JAX-written ``.pth``.
- Batches come from the u8 feed by default: a feeder thread pins each
  batch and copies it to the device on a side stream, one batch ahead
  of the step (``_device_feed``).
"""

import math
import os
import queue
import threading

import numpy as np
import torch

from . import parallel
from .data import DataIterator, RotatedDataIterator
from .infer import BatchClock, infer
from .io import checkpoint, opt_state
from .ops import apply_color_affine
from .utils import Profiler, ignore_sigint, post_metrics

VALIDATION_TAGS = [
    'Validation_Precision/mAP',
    'Validation_Precision/mAP@0.50IoU',
    'Validation_Precision/mAP@0.75IoU',
    'Validation_Precision/mAP (small)',
    'Validation_Precision/mAP (medium)',
    'Validation_Precision/mAP (large)',
    'Validation_Recall/mAR (max 1 Dets)',
    'Validation_Recall/mAR (max 10 Dets)',
    'Validation_Recall/mAR (max 100 Dets)',
    'Validation_Recall/mAR (small)',
    'Validation_Recall/mAR (medium)',
    'Validation_Recall/mAR (large)']


def lr_schedule(lr, warmup, milestones, gamma):
    """it -> learning rate: a linear warmup from 0.1 lr over ``warmup``
    steps (``it <= warmup``, the count starting at 0), then ``gamma`` per
    milestone reached (``odtk_tpu/train.py:41-56``)."""
    milestones = sorted(milestones or [])

    def schedule(it):
        if warmup and it <= warmup:
            return lr * (0.9 * it / warmup + 0.1)
        return lr * gamma ** sum(1 for m in milestones if m <= it)

    return schedule


def make_optimizer(params, lr, weight_decay=1e-4, momentum=0.9):
    """SGD (momentum, dampening 0, weight decay into the gradient) in its
    fused form, which honours the device-side skip flag. The momentum
    buffers start at zero, so a skipped first step leaves them defined
    and the first applied step equals the optax trace's."""
    params = list(params)
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0,
                          weight_decay=weight_decay, fused=True)
    for p in params:
        opt.state[p]['momentum_buffer'] = torch.zeros_like(p)
    return opt


def make_train_step(model, optimizer, clip_grads=0.0, feed='u8'):
    """The train step: ``step(lr, images, targets)`` for the f32 feed,
    ``step(lr, images_u8, targets, colors, sizes)`` for the u8 feed.
    Returns (cls_loss, box_loss) as device scalars; the host does not
    wait for the device. In a process group (made before this is
    called) the gradients and the losses are summed over the processes
    by one all-reduce after the backward, before the non-finite flag and
    the clip read them: the global batch's gradient and losses, the same
    on every rank."""
    params = [p for g in optimizer.param_groups for p in g['params']]
    grouped = parallel.grouped()

    def update(lr, images, targets):
        optimizer.zero_grad(set_to_none=True)
        cls_loss, box_loss = model.loss_fn(images, targets)
        (cls_loss + box_loss).backward()
        # every rank runs the same graph, so the same parameters have
        # gradients and the flattened buffers line up
        grads = [p.grad for p in params if p.grad is not None]
        losses = torch.stack([cls_loss.detach(), box_loss.detach()])
        if grouped:
            parallel.all_reduce_sum(grads + [losses])
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        optimizer.found_inf = (~torch.isfinite(norm)).float()
        if clip_grads and clip_grads > 0:
            torch._foreach_mul_(grads, torch.clamp(clip_grads / norm, max=1.0))
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()
        return losses[0], losses[1]

    if feed == 'f32':
        return update
    if feed != 'u8':
        raise ValueError(f'unknown feed {feed!r}')

    def step_u8(lr, images_u8, targets, colors, sizes):
        return update(lr, apply_color_affine(images_u8, colors, sizes),
                      targets)

    return step_u8


def _device_feed(data_iterator, device, prefetch=2):
    """One epoch of batches as tensors on ``device``. On CUDA a feeder
    thread pins each host batch and starts its copies on a side stream;
    the consumer's stream waits for that copy only. Loader errors
    surface in the consumer. Closing the generator stops the feeder and
    the loader's workers before it returns."""
    if device.type != 'cuda':
        for batch in data_iterator:
            yield [torch.from_numpy(a) for a in batch]
        return

    q = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    done = object()
    copy_stream = torch.cuda.Stream(device)

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                for batch in data_iterator:
                    tensors = [torch.from_numpy(a).pin_memory().to(
                        device, non_blocking=True) for a in batch]
                    event = torch.cuda.Event()
                    event.record(copy_stream)
                    if not put((tensors, event)):
                        return
            put(done)
        except Exception as e:  # noqa: BLE001 — re-raised in the consumer
            put(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        stream = torch.cuda.current_stream(device)
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            tensors, event = item
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
            yield tensors
    finally:
        stop.set()
        # the feeder closes the loader's epoch (and its workers) on its
        # way out: nothing of this epoch runs after the caller goes on
        thread.join()


class _Trace:
    """A ``torch.profiler`` trace (CPU, and CUDA on the card) written as
    a Chrome trace into ``directory`` when it stops."""

    def __init__(self, directory, device, first):
        self.directory, self.device, self.first = directory, device, first
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.start()

    def stop(self, end):
        """Stop after iteration ``end`` - 1; returns the trace's path."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.profile.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f'train_iterations_{self.first}-{end - 1}.json')
        self.profile.export_chrome_trace(path)
        return path


def train(model, state, path, annotations, val_path, val_annotations,
          resize, max_size, jitter, batch_size, iterations, val_iterations,
          lr, warmup, milestones, gamma, mixed_precision=True, verbose=True,
          metrics_url=None, logdir=None, rotate_augment=False,
          crop_augment=False, augment_brightness=0.0, augment_contrast=0.0,
          augment_hue=0.0, augment_saturation=0.0, regularization_l2=0.0001,
          max_det=128, sync_every=8, clip_grads=0.0, feed='u8',
          device='cuda', rotated_bbox=False, absolute_angle=False,
          profile_dir=None):
    """Train ``model`` for ``iterations`` steps on ``device``, in a
    process group on this rank's share of each batch of ``batch_size``
    (the global batch); rank 0 writes ``state['path']`` at the log
    cadence and at the end. Returns
    ``{'model', 'losses', 'step_ms'}``: the (iteration, focal, box)
    losses of every step, and the ms between the ends of consecutive
    steps on the device's clock (host clock on the CPU; ``BatchClock``
    of ``infer.py``), which takes no synchronization inside the loop.
    With ``profile_dir`` it also holds ``trace``, the trace's path."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but no CUDA device is '
                           'available (pass --device cpu to run on the CPU)')
    if feed not in ('u8', 'f32'):
        raise ValueError(f'unknown feed {feed!r} (the port reads u8 and f32; '
                         'yuv420 is not ported)')

    rank, world = parallel.world_info()
    # the clean startup error of a batch that does not divide
    parallel.host_local_batch_size(batch_size, world, 1)
    model.to(device)
    if parallel.grouped():
        # a fresh init draws its seed in each process: start from rank 0's
        parallel.broadcast_from_rank0([*model.module.parameters(),
                                       *model.module.buffers()])
    model.set_dtype(torch.bfloat16 if mixed_precision else torch.float32)
    if not mixed_precision:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    optimizer = make_optimizer(model.module.parameters(), lr,
                               regularization_l2)
    iteration = state.get('iteration', 0)
    # updates applied so far: the optax count (io/opt_state.py); a torch
    # state_dict holds none, so it starts at the iteration
    applied = iteration
    saved = state.pop('optimizer', None)     # may hold the file's bytes
    if isinstance(saved, dict):
        optimizer.load_state_dict(saved)
    elif saved is not None:
        count = opt_state.restore(optimizer, model.module, saved,
                                  clip_grads)
        applied = iteration if count is None else count
    del saved
    schedule = lr_schedule(lr, warmup, milestones, gamma)
    train_step = make_train_step(model, optimizer, clip_grads, feed)

    if verbose:
        print('Preparing dataset...')
    iterator_cls = RotatedDataIterator if rotated_bbox else DataIterator
    data_iterator = iterator_cls(
        path, jitter, max_size, batch_size, model.stride, world, annotations,
        training=True, rank=rank, rotate_augment=rotate_augment,
        crop_augment=crop_augment, augment_brightness=augment_brightness,
        augment_contrast=augment_contrast, augment_hue=augment_hue,
        augment_saturation=augment_saturation, max_det=max_det,
        absolute_angle=absolute_angle, emit=feed)
    if verbose:
        print(data_iterator)
        name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
                else 'CPU')
        print('   backend: torch {}'.format(torch.__version__))
        print('    device: {}'.format(name))
        print('     batch: {}, precision: {}'.format(
            batch_size, 'mixed (bf16)' if mixed_precision else 'full (fp32)'))
        if world > 1:
            print('     world: {} processes, rank {}'.format(world, rank))
        print(' BBOX type:', 'rotated' if rotated_bbox else 'axis aligned')
        print('Training model for {} iterations...'.format(iterations))

    writer = None
    if logdir is not None and rank == 0:
        from .io.events import SummaryWriter
        if verbose:
            print('Writing TensorBoard logs to: {}'.format(logdir))
        writer = SummaryWriter(logdir)

    def save_checkpoint(iteration):
        if checkpoint.is_torch_format(state['path']):
            saved = optimizer.state_dict()
        else:
            saved = opt_state.to_optax(optimizer, model.module, clip_grads,
                                       applied)
        state.update({'iteration': iteration, 'optimizer': saved,
                      'scheduler': {'last_iter': iteration}})
        with ignore_sigint():
            model.save(state)

    profiler = Profiler(['train', 'fw', 'bw'])
    profile_start = iteration + 10 if profile_dir and rank == 0 else None
    trace, trace_path = None, None
    cls_losses, box_losses, history = [], [], []
    pending = []
    diverged = None
    clock = BatchClock(device)

    def drain_pending():
        # records the first non-finite loss; it is raised at the next
        # sync, a step that is the same on every rank
        nonlocal applied, diverged
        for it_idx, shape, cl_dev, bl_dev, skipped in pending:
            cl, bl = float(cl_dev), float(bl_dev)
            if os.environ.get('ODTK_DEBUG'):
                print(f'  debug it{it_idx}: cl={cl:.4f} bl={bl:.4f} '
                      f'shape={tuple(shape)}', flush=True)
            applied += 1 - int(skipped)
            cls_losses.append(cl)
            box_losses.append(bl)
            history.append((it_idx, cl, bl))
            if diverged is None and not math.isfinite(cl + bl):
                diverged = RuntimeError(
                    'Loss is diverging! (iteration {}: focal loss {}, box '
                    'loss {})\nTry lowering the learning rate.'.format(
                        it_idx, cl, bl))
        pending.clear()

    while iteration < iterations:
        for arrays in _device_feed(data_iterator, device):
            if iteration >= iterations:
                break
            if iteration == profile_start:
                trace = _Trace(profile_dir, device, iteration)
            profiler.start('fw')
            if feed == 'u8':
                images, targets, colors, sizes = arrays
                cls_loss, box_loss = train_step(schedule(iteration), images,
                                                targets, colors, sizes)
            else:
                images, targets = arrays
                cls_loss, box_loss = train_step(schedule(iteration), images,
                                                targets)
            clock.mark()
            profiler.stop('fw')
            profiler.start('bw')
            pending.append((iteration, images.shape, cls_loss, box_loss,
                            optimizer.found_inf))
            if (iteration + 1) % max(1, sync_every) == 0 \
                    or iteration + 1 >= iterations:
                drain_pending()
                if diverged is not None:
                    raise diverged
            profiler.stop('bw')

            iteration += 1
            if trace is not None and iteration == profile_start + 10:
                trace_path = trace.stop(iteration)
                trace = None
            profiler.bump('train')
            if rank == 0 and (profiler.totals['train'] > 60
                              or iteration == iterations):
                drain_pending()
                focal_loss = float(np.mean(cls_losses))
                box_loss_m = float(np.mean(box_losses))
                learning_rate = schedule(iteration)
                if verbose:
                    msg = '[{:{len}}/{}]'.format(
                        iteration, iterations, len=len(str(iterations)))
                    msg += ' focal loss: {:.3f}'.format(focal_loss)
                    msg += ', box loss: {:.3f}'.format(box_loss_m)
                    msg += ', {:.3f}s/{}-batch'.format(
                        profiler.means['train'], batch_size)
                    msg += ' (step: {:.3f}s, sync: {:.3f}s)'.format(
                        profiler.means['fw'], profiler.means['bw'])
                    msg += ', {:.1f} im/s'.format(
                        batch_size / profiler.means['train'])
                    msg += ', lr: {:.2g}'.format(learning_rate)
                    print(msg, flush=True)
                if writer is not None:
                    writer.add_scalar('focal_loss', focal_loss, iteration)
                    writer.add_scalar('box_loss', box_loss_m, iteration)
                    writer.add_scalar('learning_rate', learning_rate,
                                      iteration)
                if metrics_url:
                    post_metrics(metrics_url, {
                        'focal loss': focal_loss,
                        'box loss': box_loss_m,
                        'im_s': batch_size / profiler.means['train'],
                        'lr': learning_rate})
                save_checkpoint(iteration)
                profiler.reset()
                del cls_losses[:], box_losses[:]

            if val_annotations and (iteration == iterations
                                    or (val_iterations
                                        and iteration % val_iterations == 0)):
                stats = infer(model, val_path, None, resize, max_size,
                              batch_size, annotations=val_annotations,
                              mixed_precision=mixed_precision,
                              verbose=False, device=device,
                              rotated_bbox=rotated_bbox)['stats']
                if writer is not None and stats is not None:
                    for tag, value in zip(VALIDATION_TAGS, stats):
                        writer.add_scalar(tag, value, iteration)
    # a run that ends inside the window closes its trace here (the JAX
    # trainer leaves it open)
    if trace is not None:
        trace_path = trace.stop(iteration)
    if writer is not None:
        writer.close()
    out = {'model': model, 'losses': history,
           'step_ms': clock.intervals_ms()}
    if profile_dir:
        out['trace'] = trace_path
    return out
