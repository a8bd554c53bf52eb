"""Training workflow on one device: the train step, the learning-rate
schedule, the checkpoint and log cadence, periodic validation.

Counterpart of ``odtk_tpu/train.py`` at world 1:

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
  guard; the checkpoint and the log line come every ~60 s and at the
  end, validation every ``val_iterations``.
- Batches come from the u8 feed by default: a feeder thread pins each
  batch and copies it to the device on a side stream, one batch ahead
  of the step (``_device_feed``).
"""

import math
import queue
import threading
import warnings

import numpy as np
import torch

from .data import DataIterator, RotatedDataIterator
from .infer import BatchClock, infer
from .ops import apply_color_affine
from .utils import Profiler, ignore_sigint


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
    wait for the device."""
    params = [p for g in optimizer.param_groups for p in g['params']]

    def update(lr, images, targets):
        optimizer.zero_grad(set_to_none=True)
        cls_loss, box_loss = model.loss_fn(images, targets)
        (cls_loss + box_loss).backward()
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        optimizer.found_inf = (~torch.isfinite(norm)).float()
        if clip_grads and clip_grads > 0:
            torch._foreach_mul_(grads, torch.clamp(clip_grads / norm, max=1.0))
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()
        return cls_loss.detach(), box_loss.detach()

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
    surface in the consumer."""
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


def train(model, state, path, annotations, val_path, val_annotations,
          resize, max_size, jitter, batch_size, iterations, val_iterations,
          lr, warmup, milestones, gamma, mixed_precision=True, verbose=True,
          rotate_augment=False, crop_augment=False, augment_brightness=0.0,
          augment_contrast=0.0, augment_hue=0.0, augment_saturation=0.0,
          regularization_l2=0.0001, max_det=128, sync_every=8,
          clip_grads=0.0, feed='u8', device='cuda', rotated_bbox=False,
          absolute_angle=False):
    """Train ``model`` for ``iterations`` steps on one device; writes
    ``state['path']`` at the log cadence and at the end. Returns
    ``{'model', 'losses', 'step_ms'}``: the (iteration, focal, box)
    losses of every step, and the ms between the ends of consecutive
    steps on the device's clock (host clock on the CPU; ``BatchClock``
    of ``infer.py``), which takes no synchronization inside the loop."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but no CUDA device is '
                           'available (pass --device cpu to run on the CPU)')
    if feed not in ('u8', 'f32'):
        raise ValueError(f'unknown feed {feed!r} (the port reads u8 and f32; '
                         'yuv420 is not ported)')

    model.to(device)
    model.set_dtype(torch.bfloat16 if mixed_precision else torch.float32)
    if not mixed_precision:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    optimizer = make_optimizer(model.module.parameters(), lr,
                               regularization_l2)
    opt_state = state.get('optimizer')
    if isinstance(opt_state, dict):
        optimizer.load_state_dict(opt_state)
    elif opt_state is not None:
        warnings.warn('the checkpoint\'s optimizer state was not written by '
                      'odtk_tpu_torch (a JAX optax blob); starting the '
                      'momentum fresh')
    schedule = lr_schedule(lr, warmup, milestones, gamma)
    train_step = make_train_step(model, optimizer, clip_grads, feed)

    if verbose:
        print('Preparing dataset...')
    iterator_cls = RotatedDataIterator if rotated_bbox else DataIterator
    data_iterator = iterator_cls(
        path, jitter, max_size, batch_size, model.stride, 1, annotations,
        training=True, rotate_augment=rotate_augment,
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
        print(' BBOX type:', 'rotated' if rotated_bbox else 'axis aligned')
        print('Training model for {} iterations...'.format(iterations))

    def save_checkpoint(iteration):
        state.update({'iteration': iteration,
                      'optimizer': optimizer.state_dict(),
                      'scheduler': {'last_iter': iteration}})
        with ignore_sigint():
            model.save(state)

    profiler = Profiler(['train', 'fw', 'bw'])
    iteration = state.get('iteration', 0)
    cls_losses, box_losses, history = [], [], []
    pending = []
    clock = BatchClock(device)

    def drain_pending():
        for it_idx, cl_dev, bl_dev in pending:
            cl, bl = float(cl_dev), float(bl_dev)
            cls_losses.append(cl)
            box_losses.append(bl)
            history.append((it_idx, cl, bl))
            if not math.isfinite(cl + bl):
                raise RuntimeError(
                    'Loss is diverging! (iteration {}: focal loss {}, box '
                    'loss {})\nTry lowering the learning rate.'.format(
                        it_idx, cl, bl))
        pending.clear()

    while iteration < iterations:
        for arrays in _device_feed(data_iterator, device):
            if iteration >= iterations:
                break
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
            pending.append((iteration, cls_loss, box_loss))
            if len(pending) >= max(1, sync_every) \
                    or iteration + 1 >= iterations:
                drain_pending()
            profiler.stop('bw')

            iteration += 1
            profiler.bump('train')
            if profiler.totals['train'] > 60 or iteration == iterations:
                drain_pending()
                focal_loss = float(np.mean(cls_losses))
                box_loss_m = float(np.mean(box_losses))
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
                    msg += ', lr: {:.2g}'.format(schedule(iteration))
                    print(msg, flush=True)
                save_checkpoint(iteration)
                profiler.reset()
                del cls_losses[:], box_losses[:]

            if val_annotations and (iteration == iterations
                                    or (val_iterations
                                        and iteration % val_iterations == 0)):
                infer(model, val_path, None, resize, max_size, batch_size,
                      annotations=val_annotations,
                      mixed_precision=mixed_precision, verbose=False,
                      device=device, rotated_bbox=rotated_bbox)
    return {'model': model, 'losses': history,
            'step_ms': clock.intervals_ms()}
