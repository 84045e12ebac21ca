"""ctypes loader for the native 3dfcoord codec (see native/xtc_codec.cpp).

Builds the shared library on first use when a compiler is available;
callers fall back to the pure-Python codec when loading fails.
"""

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libxtc_codec.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.xtc3_compress.restype = ctypes.c_longlong
        lib.xtc3_compress.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong]
        lib.xtc3_decompress.restype = ctypes.c_longlong
        lib.xtc3_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def compress_frame(coords, precision) -> bytes:
    lib = _load()
    coords = np.ascontiguousarray(coords, dtype=np.float32).reshape(-1, 3)
    natoms = coords.shape[0]
    cap = natoms * 16 + 256
    out = np.empty(cap, dtype=np.uint8)
    n = lib.xtc3_compress(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        natoms, ctypes.c_float(float(precision)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_longlong(cap))
    if n < 0:
        raise RuntimeError("native xtc compression failed")
    return out[:n].tobytes()


def decompress_frame(data: bytes, offset: int):
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)[offset:]
    natoms_peek = int.from_bytes(data[offset:offset + 4], "big", signed=True)
    coords = np.empty((max(natoms_peek, 1), 3), dtype=np.float32)
    natoms = ctypes.c_int(0)
    precision = ctypes.c_float(0.0)
    consumed = lib.xtc3_decompress(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_longlong(len(buf)),
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(natoms), ctypes.byref(precision))
    if consumed < 0:
        raise ValueError("corrupt xtc 3dfcoord stream (native codec)")
    return (coords[:natoms.value], float(precision.value),
            offset + int(consumed))
