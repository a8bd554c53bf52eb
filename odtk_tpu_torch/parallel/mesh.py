"""How a batch divides over hosts and processes (the startup guards).

Counterpart of ``odtk_tpu/parallel/mesh.py``. ``host_local_batch_size``
raises the JAX package's two errors, with their text, before any data
loads; ``processes_for_batch`` is ``make_mesh_for_batch``'s rule for how
many of a host's cards take part. ``make_mesh``, ``batch_sharding``,
``replicated_sharding``, ``shard_batch`` and ``host_local_array`` have
no counterpart: there is no global array to shard or to take a host's
rows from, because each process loads, feeds and keeps its own rows
(``data/loader.py`` shards the epoch by process) and the results are
gathered with ``all_gather_host``.
"""

import warnings


def host_local_batch_size(global_batch, hosts, local_devices):
    """Per-host batch; errors unless evenly divisible (the original's
    ``main.py:170-171``). With several hosts the per-host batch must also
    divide over the host's cards; one host keeps
    ``processes_for_batch``'s fewer-cards-with-a-warning rule."""
    if global_batch % hosts != 0:
        raise RuntimeError(
            'Batch size should be a multiple of the number of hosts')
    local = global_batch // hosts
    if hosts > 1 and local % max(1, local_devices) != 0:
        raise RuntimeError(
            'Per-host batch size should be a multiple of the local '
            'device count')
    return local


def processes_for_batch(local_batch, local_devices, hosts=1):
    """How many processes (one a card) this host runs: all its cards with
    several hosts (``host_local_batch_size`` has checked the batch), else
    the largest count up to the card count that divides the batch, with
    the JAX package's warning when that leaves cards idle."""
    if hosts > 1:
        return local_devices
    n = local_devices
    while n > 1 and local_batch % n != 0:
        n -= 1
    if n < local_devices:
        warnings.warn(
            f'batch size {local_batch} is not a multiple of the device '
            f'count {local_devices}; using {n} device(s). Make the batch '
            f'a multiple of the device count to use every chip.')
    return n
