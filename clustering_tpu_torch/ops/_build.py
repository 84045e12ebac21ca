"""Build the hand-written CUDA kernels with nvcc and bind them via ctypes.

The sources in ``clustering_tpu_torch/csrc`` have a plain C interface, so
they compile in seconds without PyTorch's headers. The shared library goes
to ``build/torch_kernels/`` at the repository root, named by a hash of the
sources, and is built at first use in a process: one nvcc per source, all
started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/torch_kernels/libck_<hash>.so *.o

Every pointer and the stream cross as ``ctypes.c_void_p``; each entry point
returns the ``cudaError_t`` of its launch.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-c"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# name -> argtypes of the C entry points
SIGNATURES = {
    # coords_t, n_pad, d, radii2, n_radii, n_valid, ti, tj, rmask,
    # n_tiles, row_block, col_block, out, steps, stream
    "ck_pops_bidir": [_P, _LL, _I, _P, _I, _I, _P, _P, _P, _LL, _I, _I,
                      _P, _P, _P],
    # coords_t, n_pad, d, fe, oid, n_valid, ti, tj, n_tiles, row_block,
    # col_block, keys, stream
    "ck_nn_bidir": [_P, _LL, _I, _P, _P, _I, _P, _P, _LL, _I, _I, _P, _P],
    # coords_t, n_pad, d, labels, n_below, max_dist2, ti, tj, dirty,
    # n_tiles, row_block, col_block, prop, stream
    "ck_label_min_bidir": [_P, _LL, _I, _P, _I, _F, _P, _P, _P, _LL, _I,
                           _I, _P, _P],
    # rows_t, r_pad, cols_t, n_pad, d, radii2, n_radii, n_valid, ti, tj,
    # rmask, n_tiles, row_block, col_block, out, stream
    "ck_pops_sparse": [_P, _LL, _P, _LL, _I, _P, _I, _I, _P, _P, _P, _LL,
                       _I, _I, _P, _P],
    # rows_t, r_pad, fe_rows, oid_rows, cols_t, n_pad, d, fe_cols, oid,
    # n_valid, ti, tj, n_tiles, row_block, col_block, keys, stream
    "ck_nn_sparse": [_P, _LL, _P, _P, _P, _LL, _I, _P, _P, _I, _P, _P, _LL,
                     _I, _I, _P, _P],
    # rows_t, r_pad, cols_t, n_pad, d, labels, n_below, max_dist2, ti, tj,
    # row_block_offset, dirty, n_tiles, row_block, col_block, prop, stream
    "ck_label_min_sparse": [_P, _LL, _P, _LL, _I, _P, _I, _F, _P, _P, _I,
                            _P, _LL, _I, _I, _P, _P],
    # rows_t, r_pad, cols_t, n_pad, d, radii2, n_radii, n_valid,
    # skip_words, words_per_row, row_block, col_block, out, stream
    "ck_pops_tiles": [_P, _LL, _P, _LL, _I, _P, _I, _I, _P, _I, _I, _I, _P,
                      _P],
    # rows_t, r_pad, fe_rows, cols_t, n_pad, d, fe_cols, orig_ids, n_valid,
    # skip_words, words_per_row, row_block, col_block, keys, stream
    "ck_nn_tiles": [_P, _LL, _P, _P, _LL, _I, _P, _P, _I, _P, _I, _I, _I,
                    _P, _P],
}

_lock = threading.Lock()


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path():
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libck_{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernels unless the library for these sources exists.
    Returns (path, compiler output)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p)[:-3] + ".o")
                for p in cu]
        procs = [subprocess.Popen(
            [nvcc] + COMPILE_FLAGS + ["-I", CSRC_DIR, "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src for src, p in zip(cu, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "".join(logs))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc] + LINK_FLAGS + ["-o", lib] + objs,
                              capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + logs[-1])
        os.replace(lib, path)
    return path, "".join(logs)


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if needed; hashed, built and
    loaded once per process."""
    with _lock:
        path, _ = build()
        lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
