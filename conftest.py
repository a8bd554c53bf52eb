"""Build the JAX package's native JPEG library once, before the tests.

``odtk_tpu/data/native.py`` builds ``native/build/libodtk_host.so`` with
cmake and ninja on first use, with no lock between processes. Under
pytest-xdist every worker imports ``tests/test_native.py``, which asks
for the library while it is collected, so the workers start that build
at once in the one shared directory and can all fail; their native tests
then skip (ROADMAP.md, Queue 3 item 4). pytest runs this hook in the
controller before it starts the workers, so the library is there when
they look for it. The build runs the commands of
``odtk_tpu/data/native.py:_build`` into a directory of its own, under a
file lock, and moves the library into place, so a half-written
``native/build/`` left by an earlier race does not matter. Without
cmake, ninja or libjpeg it does nothing, and those tests skip as before.
"""

import fcntl
import os
import shutil
import subprocess
import tempfile

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'native')
_BUILD = os.path.join(_NATIVE, 'build')
_LIB = os.path.join(_BUILD, 'libodtk_host.so')


def _build_native():
    if os.path.isfile(_LIB) or not (shutil.which('cmake')
                                     and shutil.which('ninja')):
        return
    os.makedirs(_BUILD, exist_ok=True)
    with open(_NATIVE + '/build.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(_LIB):
            return
        work = tempfile.mkdtemp(prefix='work-', dir=_BUILD)
        try:
            subprocess.run(['cmake', '-B', work, '-G', 'Ninja', _NATIVE],
                           check=True, capture_output=True, timeout=120)
            subprocess.run(['ninja', '-C', work], check=True,
                           capture_output=True, timeout=300)
            os.replace(os.path.join(work, 'libodtk_host.so'), _LIB)
        except (OSError, subprocess.SubprocessError):
            pass                # no toolchain or libjpeg: the tests skip
        finally:
            shutil.rmtree(work, ignore_errors=True)


def pytest_configure(config):
    if not hasattr(config, 'workerinput'):     # the controller, or no xdist
        _build_native()
