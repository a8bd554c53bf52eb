"""Build the package's CUDA kernels on first use and bind them with ctypes.

Every ``odtk_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process, all started together (the ``*.cuh`` headers they share are
included), and the objects are linked into one
shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library goes to ``odtk_tpu_torch/_build/``
under a name keyed by a hash of the sources, headers and flags, so an edited
source rebuilds and an unchanged one is reused; a file lock serializes
concurrent builds. Pointers and the stream cross as ``c_void_p``.

Nothing here runs at import: the CPU-only test environment imports every
module but has no ``nvcc``.
"""

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

# sm_90a: Hopper. No --use_fast_math: an approximate division flips NMS
# IoUs that sit at the threshold.
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    'odtk_nms': [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P],
    'odtk_stem_pool': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    'odtk_stem_pool_idx': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    'odtk_stem_pool_bwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    'odtk_det_loss_fwd': [_P, _I, _L, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                          _F, _P],
    'odtk_det_loss_bwd': [_P, _I, _L, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                          _P],
    'odtk_nms_rotated': [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P],
    'odtk_match_rotated': [_P, _I, _I, _P, _P, _I, _I, _P],
    'odtk_rotated_best_match': [_P, _P, _P, _I, _I, _P, _P, _P],
    'odtk_focal_sum': [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _L, _L,
                       _L, _F, _F, _P],
    'odtk_focal_sum_dx': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                          _L, _F, _F, _P],
}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    path = shutil.which('nvcc')
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, 'bin', 'nvcc')
    if path is None or not os.path.isfile(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'odtk_tpu_torch need the CUDA toolkit to build')
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC, '*.cu')))


def headers():
    return sorted(glob.glob(os.path.join(CSRC, '*.cuh')))


def library_path():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'libodtk_kernels_{h.hexdigest()[:16]}.so')


def _run_all(cmds):
    """Run the commands in parallel; raise with the first failure's
    output after all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}):\n'
                          f'{" ".join(cmd)}\n{err}')
    if failed:
        raise RuntimeError(failed[0])


def build():
    """Compile csrc/*.cu unless the library for these sources exists:
    one nvcc per source, all at once, then one link. Returns the
    library's path."""
    out = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, 'lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(out):
            nvcc = _nvcc()
            work = f'{out}.{os.getpid()}.d'
            os.makedirs(work, exist_ok=True)
            try:
                objs = [os.path.join(work, os.path.basename(src) + '.o')
                        for src in sources()]
                _run_all([[nvcc, *NVCC_FLAGS, '-c', src, '-o', obj]
                          for src, obj in zip(sources(), objs)])
                tmp = os.path.join(work, 'lib.so')
                _run_all([[nvcc, *NVCC_FLAGS, '-shared', '-o', tmp, *objs]])
                os.replace(tmp, out)
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return out


@functools.cache
def library():
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc, name):
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc}')


def stream_handle(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def level_groups(n, limit):
    """Slices cutting ``n`` independent levels into launches of at most
    ``limit`` (a multi-level kernel's ``kMaxLevels``): the launches give
    the rows one launch of all levels would."""
    return [slice(lo, lo + limit) for lo in range(0, n, limit)]
