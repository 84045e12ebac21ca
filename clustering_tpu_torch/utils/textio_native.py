"""ctypes loader for the native ASCII parse/format helpers
(see native/textio.cpp).

Builds the shared library on first use when a compiler is available;
callers fall back to numpy/pure-Python paths when loading fails. Parsing
and formatting are both correctly rounded, hence bit-identical to
CPython's float()/"%e"/"%g"/str(int) (fuzz-tested in tests/test_io.py).
"""

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libtextio.so")

_I64P = ctypes.POINTER(ctypes.c_longlong)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_char)
_LL = ctypes.c_longlong


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
        lib.count_ws_tokens.restype = _LL
        lib.count_ws_tokens.argtypes = [_U8P, _LL]
        lib.parse_f64.restype = _LL
        lib.parse_f64.argtypes = [_U8P, _LL, _F64P, _LL]
        lib.parse_i64.restype = _LL
        lib.parse_i64.argtypes = [_U8P, _LL, _I64P, _LL]
        lib.format_e.restype = _LL
        lib.format_e.argtypes = [_F64P, _LL, _U8P, _LL]
        lib.format_i64.restype = _LL
        lib.format_i64.argtypes = [_I64P, _LL, _U8P, _LL]
        lib.format_nn.restype = _LL
        lib.format_nn.argtypes = [_I64P, _F64P, _I64P, _F64P, _LL, _U8P,
                                  _LL]
        lib.format_kv_ig.restype = _LL
        lib.format_kv_ig.argtypes = [_I64P, _F64P, _LL, ctypes.c_int,
                                     _U8P, _LL]
        _LIB = lib
        if os.environ.get("CLUSTERING_TPU_MALLOC_TUNE") != "0":
            try:
                # raise glibc's mmap threshold once per process: repeated
                # multi-MB numpy buffers (finish postludes, download
                # destinations) then reuse heap pages instead of paying
                # a fresh-mmap page-fault storm (2.2s for a 24MB first
                # touch measured in-situ on the target VM; ~2ms reused)
                lib.tune_host_malloc()
            except AttributeError:
                pass  # stale .so without the symbol; harmless
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def set_max_threads(n: int) -> None:
    """Cap the native parser/formatter thread pools (CLI -n/--nthreads;
    reference wires the flag to omp_set_num_threads, clustering.cpp:454-459).
    0 restores auto (hardware concurrency)."""
    lib = _load()
    if lib is not None:
        try:
            lib.set_max_threads(ctypes.c_int(int(n)))
        except AttributeError:
            pass  # stale .so without the symbol; harmless


def line_cols(body: bytes):
    """Uniform tokens-per-line count of a numeric table: >0 common width,
    0 for no tokens, -1 for ragged lines, None when the native library
    (or a stale .so without the symbol) is unavailable."""
    lib = _load()
    if lib is None:
        return None
    try:
        fn = lib.line_cols
    except AttributeError:
        return None  # stale .so without the symbol
    fn.restype = ctypes.c_longlong
    return int(fn(body, _LL(len(body))))


def parse_tokens(body: bytes, np_dtype):
    """Parse every whitespace-separated token of ``body`` as int64/float64.

    Returns None when any token fails to parse in full (the caller falls
    back to the exact per-token line-skip loop)."""
    lib = _load()
    # over-allocate to the token-count upper bound (every token needs a
    # separator, so <= len//2 + 1) to skip a separate counting pass; fall
    # back to exact counting when that would be too large
    cap = len(body) // 2 + 2
    if cap * 8 > 1 << 31:
        cap = int(lib.count_ws_tokens(body, _LL(len(body))))
        if cap <= 0:
            return None
    out = np.empty(cap, dtype=np_dtype)
    if np_dtype == np.int64:
        got = lib.parse_i64(body, _LL(len(body)),
                            out.ctypes.data_as(_I64P), _LL(len(out)))
    else:
        got = lib.parse_f64(body, _LL(len(body)),
                            out.ctypes.data_as(_F64P), _LL(len(out)))
    if got <= 0:
        return None
    return out[:int(got)]


def nn_finish(coords, jj, frame0=0):
    """NN-finish host postlude: zeroed int64 id rows + fp32 squared
    distances recomputed from ``coords`` (n, d) for the raw (2, n) int32
    id download ``jj`` (INT32_MAX = no admissible neighbor). One native
    pass, bit-identical to the numpy fallback in ops/engine.py (see
    native/textio.cpp::nn_finish_host). ``frame0``: global frame id of
    ``jj``'s first column (the streamed finish passes frame-range
    chunks). Returns (nh_j, hd_j, nh_d, hd_d) or None when the native
    library is unavailable/stale."""
    lib = _load()
    sym = "nn_finish_host_range" if frame0 else "nn_finish_host"
    if lib is None or not hasattr(lib, sym):
        return None
    c = np.ascontiguousarray(coords, dtype=np.float32)
    ids = np.ascontiguousarray(jj, dtype=np.int32)
    n = ids.shape[1]
    nh_j = np.empty(n, dtype=np.int64)
    hd_j = np.empty(n, dtype=np.int64)
    nh_d = np.empty(n, dtype=np.float32)
    hd_d = np.empty(n, dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    args = [c.ctypes.data_as(f32p), _LL(c.shape[0]),
            _LL(c.shape[1]), ids.ctypes.data_as(i32p), _LL(n)]
    if frame0:
        args.append(_LL(frame0))
    getattr(lib, sym)(*args,
                      nh_j.ctypes.data_as(_I64P),
                      hd_j.ctypes.data_as(_I64P),
                      nh_d.ctypes.data_as(f32p),
                      hd_d.ctypes.data_as(f32p))
    return nh_j, hd_j, nh_d, hd_d


def has_nn_finish_u24():
    lib = _load()
    return lib is not None and hasattr(lib, "nn_finish_host_u24")


def nn_finish_u24(coords, packed):
    """nn_finish for the u24-packed ids download: ``packed`` is the
    (2, 3, n) uint8 byte-plane array from engine._nn_finish_idx_u24
    (6 bytes/frame instead of 8); decoded ids >= n_frames mean "no
    admissible neighbor" (see textio.cpp::nn_finish_host_u24).  Returns
    (nh_j, hd_j, nh_d, hd_d) or None when the library lacks the
    symbol."""
    lib = _load()
    if lib is None or not hasattr(lib, "nn_finish_host_u24"):
        return None
    c = np.ascontiguousarray(coords, dtype=np.float32)
    b = np.ascontiguousarray(packed, dtype=np.uint8)
    n = b.shape[2]
    nh_j = np.empty(n, dtype=np.int64)
    hd_j = np.empty(n, dtype=np.int64)
    nh_d = np.empty(n, dtype=np.float32)
    hd_d = np.empty(n, dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.nn_finish_host_u24(c.ctypes.data_as(f32p), _LL(c.shape[0]),
                           _LL(c.shape[1]), b.ctypes.data_as(_U8P),
                           _LL(n),
                           nh_j.ctypes.data_as(_I64P),
                           hd_j.ctypes.data_as(_I64P),
                           nh_d.ctypes.data_as(f32p),
                           hd_d.ctypes.data_as(f32p))
    return nh_j, hd_j, nh_d, hd_d


def pops_finish(counts_padded, n, order):
    """Pops-finish host postlude: scatter-unsort each radius row of the
    padded (r, n_pad) int32 OR uint16 device download back to original
    frame positions (``order``: sorted position -> original id, or None)
    and widen to int64, one native pass (see
    textio.cpp::pops_finish_host / pops_finish_host_u16; the narrow
    variant serves the engine's halved-bytes counts fetch).  Returns an
    (r, n) int64 array, or None when the native library is
    unavailable/stale."""
    lib = _load()
    if lib is None or not hasattr(lib, "pops_finish_host"):
        return None
    narrow = (counts_padded.dtype == np.uint16
              and hasattr(lib, "pops_finish_host_u16"))
    if narrow:
        c = np.ascontiguousarray(counts_padded, dtype=np.uint16)
        fn = lib.pops_finish_host_u16
        cptr = c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
    else:
        c = np.ascontiguousarray(counts_padded, dtype=np.int32)
        fn = lib.pops_finish_host
        cptr = c.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    r = c.shape[0]
    if order is None:
        optr = None
    else:
        order = np.ascontiguousarray(order, dtype=np.int64)
        optr = order.ctypes.data_as(_I64P)
    out = np.empty((r, n), dtype=np.int64)
    fn(cptr, _LL(r), _LL(n), _LL(c.shape[1]), optr,
       out.ctypes.data_as(_I64P))
    return out


def _run_format(fn, arrays, n, per_line, extra=()):
    buf = np.empty(n * per_line + 16, dtype=np.uint8)
    w = fn(*arrays, _LL(n), *extra, buf.ctypes.data_as(_U8P),
           _LL(len(buf)))
    if w < 0:
        raise RuntimeError("native text formatting failed")
    return memoryview(buf)[:int(w)]


def format_e(values):
    """b"%e\\n" per value (bytes-like)."""
    lib = _load()
    v = np.ascontiguousarray(values, dtype=np.float64)
    return _run_format(lib.format_e, [v.ctypes.data_as(_F64P)], len(v), 32)


def format_i64(values):
    """b"%d\\n" per value (bytes-like)."""
    lib = _load()
    v = np.ascontiguousarray(values, dtype=np.int64)
    return _run_format(lib.format_i64, [v.ctypes.data_as(_I64P)], len(v),
                       24)


def coring_pass(seg, cw, limit_rel, iterative):
    """One-pass dynamical-coring scan of one concat chunk (see
    native/textio.cpp::coring_pass). Returns (cored int64, in_core bool)
    or None when the native library is unavailable/stale."""
    lib = _load()
    if lib is None or not hasattr(lib, "coring_pass"):
        return None
    s = np.ascontiguousarray(seg, dtype=np.int64)
    w = np.ascontiguousarray(cw, dtype=np.int64)
    m = len(s)
    cored = np.empty(m, dtype=np.int64)
    incore = np.empty(m, dtype=np.int8)
    i8p = ctypes.POINTER(ctypes.c_byte)
    lib.coring_pass(s.ctypes.data_as(_I64P), _LL(m),
                    w.ctypes.data_as(_I64P), _LL(limit_rel),
                    ctypes.c_int(1 if iterative else 0),
                    cored.ctypes.data_as(_I64P),
                    incore.ctypes.data_as(i8p))
    return cored, incore.astype(bool)


def format_g_rows(rows):
    """b" %g %g ...\\n" per float32 row of a 2-D array (bytes-like), the
    ASCII coords-row format of the filter mode. None when the native
    library (or a stale .so without the symbol) is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "format_g_rows"):
        return None
    v = np.ascontiguousarray(rows, dtype=np.float32)
    n, d = v.shape
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.format_g_rows.restype = _LL
    return _run_format(lib.format_g_rows, [v.ctypes.data_as(f32p)], n,
                       41 * d + 2, extra=(_LL(d),))


def format_f_rows(rows, prec=6):
    """b"%.<prec>f %.<prec>f ...\\n" per float32 row of a 2-D array
    (bytes-like): the bytes ``np.savetxt(fmt="%.<prec>f")`` writes. None
    when the native library (or a stale .so without the symbol) is
    unavailable; ValueError for a magnitude of 1e15 or more, or ``prec``
    outside 0-17."""
    lib = _load()
    if lib is None or not hasattr(lib, "format_f_rows"):
        return None
    v = np.ascontiguousarray(rows, dtype=np.float32)
    n, d = v.shape
    f32p = ctypes.POINTER(ctypes.c_float)
    fn = lib.format_f_rows
    fn.restype = _LL
    fn.argtypes = [f32p, _LL, _LL, ctypes.c_int, _U8P, _LL]
    try:
        return _run_format(fn, [v.ctypes.data_as(f32p)], n,
                           d * (prec + 20) + 1,
                           extra=(_LL(d), ctypes.c_int(prec)))
    except RuntimeError as exc:
        raise ValueError("format_f_rows: a value of magnitude 1e15 or"
                         f" more, or precision {prec} outside 0-17") from exc


def format_kv_ig(keys, vals, swap=False):
    """b"key value\\n" (or "value key\\n" with swap) rows: int64 keys,
    %g values (bytes-like)."""
    lib = _load()
    k = np.ascontiguousarray(keys, dtype=np.int64)
    v = np.ascontiguousarray(vals, dtype=np.float64)
    return _run_format(
        lib.format_kv_ig,
        [k.ctypes.data_as(_I64P), v.ctypes.data_as(_F64P)],
        len(k), 72, extra=[ctypes.c_int(1 if swap else 0)])


def format_nn(nh_idx, nh_dist, hd_idx, hd_dist):
    """b"id dsqr id_hd dsqr_hd\\n" rows with %g distances (bytes-like)."""
    lib = _load()
    a = np.ascontiguousarray(nh_idx, dtype=np.int64)
    b = np.ascontiguousarray(nh_dist, dtype=np.float64)
    c = np.ascontiguousarray(hd_idx, dtype=np.int64)
    d = np.ascontiguousarray(hd_dist, dtype=np.float64)
    return _run_format(lib.format_nn,
                       [a.ctypes.data_as(_I64P), b.ctypes.data_as(_F64P),
                        c.ctypes.data_as(_I64P), d.ctypes.data_as(_F64P)],
                       len(a), 96)


def morton_order_pad(coords):
    """Morton frame order (int64 (n,)) in one native pass -- bit-identical
    to ops/pruning.py::morton_order (float64 quantization, stable sort;
    equality fuzz-pinned in tests/test_io.py); the native function's
    padded layout is not asked for (null). None when the native library
    is unavailable/stale -- callers keep the numpy path."""
    lib = _load()
    if lib is None or not hasattr(lib, "morton_order_pad"):
        return None
    fn = lib.morton_order_pad
    fn.restype = _LL
    c = np.ascontiguousarray(coords, dtype=np.float32)
    n, d = c.shape
    order = np.empty(n, dtype=np.int64)
    rc = fn(c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _LL(n),
            ctypes.c_int(d), _LL(n), order.ctypes.data_as(_I64P), None)
    return order if rc == 0 else None
