"""The process group and the collectives of data-parallel runs.

Counterpart of ``odtk_tpu/parallel/dist.py``, which calls
``jax.distributed.initialize`` once a host. Here every process (one a
card, or one a host on the CPU) joins one ``torch.distributed`` group
at the ``--master`` endpoint, as the original ODTK's ``main.py:155-168``
does: NCCL between cards, gloo between CPU processes.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(master, num_hosts, host_id, device='cuda',
                     local_rank=0, local_processes=1, timeout=TIMEOUT):
    """Join the group of ``num_hosts`` x ``local_processes`` processes as
    rank ``host_id`` x ``local_processes`` + ``local_rank``; ``master`` is
    'address:port' (the ``--master`` flag), served by rank 0. The backend
    follows ``device``: NCCL for CUDA, on card ``local_rank`` (or the
    card ``device`` names), which becomes the current device, gloo for
    the CPU. Collectives that wait
    longer than ``timeout`` raise. Returns (rank, world)."""
    world = num_hosts * local_processes
    rank = host_id * local_processes + local_rank
    if torch.device(device).type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('device cuda requested but no CUDA device is '
                               'available (pass --device cpu to run on the '
                               'CPU)')
        if not dist.is_nccl_available():
            raise RuntimeError('device cuda needs the NCCL backend, which '
                               'this torch build lacks')
        index = torch.device(device).index
        torch.cuda.set_device(local_rank if index is None else index)
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend, init_method=f'tcp://{master}',
                            rank=rank, world_size=world, timeout=timeout)
    return rank, world


def grouped():
    """Whether this process is in a group."""
    return dist.is_available() and dist.is_initialized()


def world_info():
    """(rank, world); (0, 1) without a group."""
    if not grouped():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _group_device():
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_sum(tensors):
    """Sum each tensor over the group, in place: one all-reduce of them
    all, flattened into one buffer (a profiler range of this name holds
    the flatten, the collective and the copy back)."""
    with torch.profiler.record_function('all_reduce_sum'):
        flat = _flatten_dense_tensors(tensors)
        dist.all_reduce(flat)
        torch._foreach_copy_(tensors,
                             _unflatten_dense_tensors(flat, tensors))


def broadcast_from_rank0(tensors):
    """Overwrite each tensor with rank 0's, in place."""
    for t in tensors:
        dist.broadcast(t.detach(), 0)


def all_gather_host(arr):
    """Gather a tensor or array of the same shape on every rank (the eval
    results' merge, the original's ``infer.py:98-102``): numpy [world,
    ...] in rank order, fetched to the host once. Under NCCL the gather
    runs on the card. Without a group, or at world 1, the identity (as
    numpy)."""
    if world_info()[1] == 1:
        return np.asarray(arr.cpu() if torch.is_tensor(arr) else arr)
    t = torch.as_tensor(arr).to(_group_device()).contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()
