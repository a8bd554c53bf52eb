"""Data parallelism: one process a card, the batch split over them.

Counterpart of ``odtk_tpu/parallel/``. The JAX package runs one process
a host over a ``data`` mesh, with the batch sharded across the host's
chips and the gradient psum inserted by XLA. Here every process feeds,
runs and keeps its own rows on its own card, as the original ODTK's
processes do (SURVEY.md §2.4), over NCCL between cards (gloo between
CPU processes). What the mesh did inside one jitted step is done by
hand: the loss is normalized over the global batch
(``Model.loss_fn``) and the gradients are summed across the processes
(``train.make_train_step``), so a step equals the JAX package's step on
the whole batch.
"""

from .dist import (all_gather_host, all_reduce_sum, broadcast_from_rank0,
                   grouped, init_distributed, world_info)
from .mesh import host_local_batch_size, processes_for_batch

__all__ = ['init_distributed', 'world_info', 'grouped', 'all_gather_host',
           'all_reduce_sum', 'broadcast_from_rank0', 'host_local_batch_size',
           'processes_for_batch']
