"""Configure and build the C++ samples (``odtk_ops``, ``odtk_export``,
``odtk_infer``, and ``odtk_infervideo`` where CMake finds OpenCV) with
CMake and Ninja, against the libtorch of the installed ``torch``.

    python -m odtk_tpu_torch.extras.cppapi.build

With a CUDA build of torch the kernel library of
``odtk_tpu_torch/ops/kernels/_build.py`` is built first and linked into
``odtk_ops``, which then holds the ``odtk::`` operators' CUDA
implementations; with a CPU build ``odtk_ops`` holds their schemas
alone. The build goes to
``odtk_tpu_torch/_build/cppapi/<key>/``, keyed by a hash of the sources,
torch's version and the kernel library, under a file lock: an unchanged
tree is reused. Nothing runs at import.
"""

import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(HERE)), '_build',
                          'cppapi')
TIMEOUT = 1200           # seconds for each of configure and build


def _sources():
    return sorted(glob.glob(os.path.join(HERE, '*.cpp'))
                  + glob.glob(os.path.join(HERE, '*.h'))
                  + [os.path.join(HERE, 'CMakeLists.txt')])


def _key(kernels_lib):
    import torch

    h = hashlib.sha256(f'{torch.__version__} {kernels_lib}'.encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmd, what):
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f'{what} failed ({proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{proc.stdout[-4000:]}\n'
                           f'{proc.stderr[-4000:]}')
    return proc.stdout


def build(verbose=False):
    """Build the samples unless this tree's build exists; returns
    {'dir': build dir, 'seconds': build seconds (0 when reused),
    'configure': CMake's odtk status lines, <target>: binary path} for the
    targets built."""
    import torch

    if shutil.which('cmake') is None or shutil.which('ninja') is None:
        raise RuntimeError('cmake and ninja are needed to build the C++ '
                           'samples')
    kernels_lib = ''
    if torch.version.cuda is not None:
        from odtk_tpu_torch.ops.kernels import _build
        kernels_lib = _build.build()
    out = os.path.join(BUILD_ROOT, _key(kernels_lib))
    os.makedirs(BUILD_ROOT, exist_ok=True)
    seconds, log = 0.0, os.path.join(out, 'configure.log')
    with open(os.path.join(BUILD_ROOT, 'lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(os.path.join(out, 'done')):
            shutil.rmtree(out, ignore_errors=True)
            start = time.perf_counter()
            configure = _run(
                ['cmake', '-S', HERE, '-B', out, '-G', 'Ninja',
                 f'-DCMAKE_PREFIX_PATH={torch.utils.cmake_prefix_path}',
                 f'-DODTK_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}',
                 f'-DODTK_KERNELS_LIB={kernels_lib}'], 'cmake configure')
            _run(['cmake', '--build', out], 'cmake build')
            seconds = time.perf_counter() - start
            with open(log, 'w') as f:
                f.write(configure)
            open(os.path.join(out, 'done'), 'w').close()
    with open(log) as f:
        status = [line.strip('- \n') for line in f
                  if 'odtk cppapi' in line]
    result = {'dir': out, 'seconds': seconds, 'configure': status}
    for name in ('odtk_export', 'odtk_infer', 'odtk_infervideo'):
        path = os.path.join(out, name)
        if os.path.isfile(path):
            result[name] = path
    if verbose:
        print('\n'.join(status))
        print(f'built {sorted(k for k in result if k.startswith("odtk"))} '
              f'in {out} ({seconds:.1f} s)')
    return result


if __name__ == '__main__':
    build(verbose=True)
