"""ctypes bridge to the native host decoder (``native/host_decode.cpp``).

A copy of ``odtk_tpu/data/native.py``: JPEG decode + bilinear resize
(+ fused ImageNet normalization) and the yuv420 feed's RGB -> YCbCr
4:2:0 converter in C++, called from loader threads with the GIL
released. The library is built on first use from the repository's
``native/`` sources into ``odtk_tpu_torch/_build/native/``, under a name
keyed by a hash of the sources. The build holds a file lock and writes into a per-process
directory whose library is then renamed into place, so concurrent
processes wait for one build instead of racing it. Without cmake, ninja
or libjpeg the loader takes its PIL path.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), 'native')
BUILD_DIR = os.path.join(_PKG, '_build', 'native')
_SOURCES = ('CMakeLists.txt', 'host_decode.cpp')


def library_path():
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(NATIVE_DIR, name), 'rb') as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f'libodtk_host_{h.hexdigest()[:16]}.so')


def _build():
    """Build the library unless it exists; its path, or None when the
    toolchain is missing or the build fails."""
    try:
        out = library_path()
    except OSError:              # native/ sources absent
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, 'lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):
            return out
        work = os.path.join(BUILD_DIR, f'work.{os.getpid()}')
        try:
            subprocess.run(['cmake', '-B', work, '-G', 'Ninja', NATIVE_DIR],
                           check=True, capture_output=True, timeout=120)
            subprocess.run(['ninja', '-C', work], check=True,
                           capture_output=True, timeout=300)
            os.replace(os.path.join(work, 'libodtk_host.so'), out)
        except (OSError, subprocess.SubprocessError):
            return None          # missing toolchain -> PIL path
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.odtk_decode_jpeg_resize_normalize.restype = ctypes.c_int
        lib.odtk_decode_jpeg_resize_normalize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.odtk_resize_normalize.restype = ctypes.c_int
        lib.odtk_resize_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.odtk_decode_jpeg_resize_u8.restype = ctypes.c_int
        lib.odtk_decode_jpeg_resize_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float)]
        lib.odtk_resize_u8.restype = ctypes.c_int
        lib.odtk_resize_u8.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
        # guarded as in the JAX bridge: a library without the converter
        # leaves the yuv420 feed on its numpy twin
        try:
            lib.odtk_rgb_to_yuv420.restype = ctypes.c_int
            lib.odtk_rgb_to_yuv420.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_ubyte)]
            lib._has_yuv = True
        except AttributeError:
            lib._has_yuv = False
        _LIB = lib
        return _LIB


def available():
    return _load() is not None


def decode_jpeg(data, resize, max_size, pad_to=None, normalize=True,
                out=None):
    """JPEG bytes -> (float32 [th|pad_h, tw|pad_w, 3], th, tw, ratio)
    or None if the native path is unavailable/failed.

    ``out``: optional caller-provided contiguous float32 [H,W,3] buffer
    (e.g. one row of a batch canvas) decoded into directly — the image
    lands top-left, margins zeroed, no intermediate copy."""
    lib = _load()
    if lib is None:
        return None
    if out is not None:
        assert out.dtype == np.float32 and out.flags.c_contiguous
        pad_h, pad_w = out.shape[:2]
    else:
        # worst-case resized dims bound the output allocation
        pad_h, pad_w = pad_to if pad_to else (max_size, max_size)
        out = np.empty((pad_h, pad_w, 3), np.float32)
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    ratio = ctypes.c_float()
    rc = lib.odtk_decode_jpeg_resize_normalize(
        data, len(data), int(resize), int(max_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pad_h, pad_w, ctypes.byref(oh), ctypes.byref(ow),
        ctypes.byref(ratio), int(normalize))
    if rc != 0:
        return None
    return out, oh.value, ow.value, float(ratio.value)


def decode_jpeg_u8(data, resize, max_size, pad_to=None, out=None):
    """JPEG bytes -> (uint8 [pad_h, pad_w, 3], th, tw, ratio) or None.

    The transfer-thin twin of decode_jpeg: no color math, u8 output —
    the color-jitter+normalize affine runs on-device instead (4x fewer
    bytes over the host->device link)."""
    lib = _load()
    if lib is None:
        return None
    if out is not None:
        assert out.dtype == np.uint8 and out.flags.c_contiguous
        pad_h, pad_w = out.shape[:2]
    else:
        pad_h, pad_w = pad_to if pad_to else (max_size, max_size)
        out = np.empty((pad_h, pad_w, 3), np.uint8)
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    ratio = ctypes.c_float()
    rc = lib.odtk_decode_jpeg_resize_u8(
        data, len(data), int(resize), int(max_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        pad_h, pad_w, ctypes.byref(oh), ctypes.byref(ow),
        ctypes.byref(ratio))
    if rc != 0:
        return None
    return out, oh.value, ow.value, float(ratio.value)


def resize_rgb_u8(rgb_u8, out_h, out_w):
    """RGB uint8 [h, w, 3] -> uint8 [out_h, out_w, 3] (native bilinear)."""
    lib = _load()
    if lib is None:
        return None
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.odtk_resize_u8(
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        rgb_u8.shape[0], rgb_u8.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_h, out_w)
    if rc != 0:
        return None
    return out


def resize_rgb(rgb_u8, out_h, out_w, normalize=True):
    """RGB uint8 [h, w, 3] -> float32 [out_h, out_w, 3] (native bilinear)."""
    lib = _load()
    if lib is None:
        return None
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.odtk_resize_normalize(
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        rgb_u8.shape[0], rgb_u8.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_h, out_w, int(normalize))
    if rc != 0:
        return None
    return out


def rgb_to_yuv420(rgb_u8):
    """RGB u8 [h,w,3] -> (y u8 [h,w], cbcr u8 [ceil/2, ceil/2, 2]) via
    the native converter, or None (caller falls back to numpy)."""
    lib = _load()
    if lib is None or not getattr(lib, '_has_yuv', False):
        return None
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = rgb_u8.shape[:2]
    y = np.empty((h, w), np.uint8)
    c = np.empty(((h + 1) // 2, (w + 1) // 2, 2), np.uint8)
    rc = lib.odtk_rgb_to_yuv420(
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        return None
    return y, c
