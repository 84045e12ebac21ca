"""Build the hand-written CUDA kernels with nvcc and bind them via ctypes.

The sources in ``clustering_tpu_torch/csrc`` have a plain C interface, so
they compile in seconds without PyTorch's headers. The shared library goes
to ``build/torch_kernels/`` at the repository root, named by a hash of the
sources, and is built at first use in a process::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/libck_<hash>.so csrc/*.cu

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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# name -> argtypes of the C entry points
SIGNATURES = {
    # coords_t, n_pad, d, radii2, n_radii, n_valid, ti, tj, rmask,
    # n_tiles, row_block, col_block, out, stream
    "ck_pops_bidir": [_P, _LL, _I, _P, _I, _I, _P, _P, _P, _LL, _I, _I,
                      _P, _P],
    # coords_t, n_pad, d, fe, oid, n_valid, ti, tj, n_tiles, row_block,
    # col_block, keys, stream
    "ck_nn_bidir": [_P, _LL, _I, _P, _P, _I, _P, _P, _LL, _I, _I, _P, _P],
    # coords_t, n_pad, d, labels, n_below, max_dist2, ti, tj, dirty,
    # n_tiles, row_block, col_block, prop, stream
    "ck_label_min_bidir": [_P, _LL, _I, _P, _I, _F, _P, _P, _P, _LL, _I,
                           _I, _P, _P],
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
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libck_{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernels unless the library for these sources exists.
    Returns (path, compiler output)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in sources() if p.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC_DIR, "-o", tmp] + cu
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


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
