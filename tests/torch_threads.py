"""The ``one_torch_thread`` fixture: torch on one intra-op thread for a
test module.

The suite runs its files on six pytest workers that share the host's
cores. In each worker torch's OpenMP pool starts one thread a core, and
at every parallel region's barrier those threads wait on the scheduler
against the other workers'. The port's tests issue many small ops (the
plain-torch replays of the kernels, CPU training runs at 64 px), so
they pay that wait on nearly every op: the unbatched matcher's 200-row
replay took 148 s with 8 threads on an 8-core host beside five busy
workers, and 2.6 s with one. The results do not depend on the count
beyond the order of a reduction's partial sums, and every comparison in
a module runs under the same count.

Import it into a test module (``from torch_threads import
one_torch_thread  # noqa: F401``): it applies to every test there and
restores the count after the module. A CLI run in a subprocess takes
``ONE_THREAD_ENV`` into its environment.
"""

import pytest
import torch

ONE_THREAD_ENV = {'OMP_NUM_THREADS': '1'}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
