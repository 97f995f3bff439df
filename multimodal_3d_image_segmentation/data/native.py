"""ctypes bindings for the native (C++/OpenMP) data-plane kernels.

Loads ``native/libm3seg_native.so``; builds it on demand with g++ from the
tracked source ``native/m3seg_native.cpp`` if missing. All callers fall
back to the pure-Python implementations when the library is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = ["get_lib", "affine_nn", "zscore_masked", "available",
           "gunzip", "gunzip_batch"]

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libm3seg_native.so")


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "m3seg_native.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-fopenmp", "-shared", "-o", _SO_PATH,
             src, "-lz"],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.affine_nn_3d.argtypes = [c_float_p, c_float_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64, c_double_p,
                                 c_double_p, ctypes.c_float]
    lib.affine_nn_2d.argtypes = [c_float_p, c_float_p, ctypes.c_int64,
                                 ctypes.c_int64, c_double_p, c_double_p,
                                 ctypes.c_float]
    lib.zscore_masked.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_int]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gunzip_file.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64]
    lib.gunzip_file.restype = ctypes.c_int64
    lib.gunzip_batch.argtypes = [ctypes.c_int32,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(u8p),
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def affine_nn(channel: np.ndarray, a: np.ndarray, t: np.ndarray,
              cval: float) -> Optional[np.ndarray]:
    """Nearest-neighbor affine resample of one channel (2D or 3D array in
    index coordinates); returns None if the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(channel, dtype=np.float32)
    out = np.empty_like(x)
    a = np.ascontiguousarray(a, dtype=np.float64)
    t = np.ascontiguousarray(t, dtype=np.float64)
    if x.ndim == 3:
        lib.affine_nn_3d(_fptr(x), _fptr(out), *map(ctypes.c_int64, x.shape),
                         _dptr(a), _dptr(t), ctypes.c_float(cval))
    elif x.ndim == 2:
        lib.affine_nn_2d(_fptr(x), _fptr(out), *map(ctypes.c_int64, x.shape),
                         _dptr(a), _dptr(t), ctypes.c_float(cval))
    else:
        return None
    return out


def zscore_masked(data: np.ndarray, mask_val=None) -> Optional[np.ndarray]:
    """In-place masked z-score; returns None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(data, dtype=np.float32)
    lib.zscore_masked(_fptr(x), ctypes.c_int64(x.size),
                      ctypes.c_float(0.0 if mask_val is None else mask_val),
                      ctypes.c_int(0 if mask_val is None else 1))
    return x


def _gz_isize(path) -> int:
    """Uncompressed size from the gzip ISIZE trailer (mod 2^32; callers
    fall back to Python on multi-member files where this undercounts).

    Validates the 0x1f 0x8b magic and caps the implied expansion ratio so
    a corrupted/truncated file whose last 4 bytes decode to a huge value
    cannot drive a multi-GB allocation; returns 0 (= fallback) instead.
    """
    with open(path, "rb") as f:
        magic = f.read(2)
        if magic != b"\x1f\x8b":
            return 0
        csize = f.seek(0, os.SEEK_END)
        if csize < 18:  # 10-byte header + 8-byte trailer minimum
            return 0
        f.seek(-4, os.SEEK_END)
        isize = int.from_bytes(f.read(4), "little")
    # NIfTI volumes compress at most ~100x in practice (all-zero planes);
    # beyond 1000x the trailer is almost certainly garbage.
    if isize > max(csize, 4096) * 1000:
        return 0
    return isize


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gunzip(path) -> Optional[np.ndarray]:
    """Native decompress of one .gz file; uint8 array or None (fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        isize = _gz_isize(path)
    except OSError:
        return None
    if isize <= 0:
        return None
    buf = np.empty(isize, np.uint8)
    n = lib.gunzip_file(os.fspath(path).encode(), _u8ptr(buf),
                        ctypes.c_int64(isize))
    if n != isize:
        return None
    return buf


def gunzip_batch(paths) -> Optional[list]:
    """Parallel decompress of many .gz files (OpenMP; GIL released for the
    whole batch). Returns a list of uint8 arrays, entries None where the
    native path could not handle the file; or None if the library is
    missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    bufs, caps = [], (ctypes.c_int64 * n)()
    cpaths = (ctypes.c_char_p * n)()
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    for i, p in enumerate(paths):
        try:
            isize = _gz_isize(p)
        except OSError:
            isize = 0
        buf = np.empty(max(isize, 1), np.uint8)
        bufs.append((buf, isize))
        caps[i] = isize
        cpaths[i] = os.fspath(p).encode()
        outs[i] = _u8ptr(buf)
    sizes = (ctypes.c_int64 * n)()
    lib.gunzip_batch(ctypes.c_int32(n), cpaths, outs, caps, sizes)
    return [buf if (isize > 0 and sizes[i] == isize) else None
            for i, (buf, isize) in enumerate(bufs)]
