"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process at first use
(all started together), and the objects are linked into ONE shared library
with a plain C interface, `_build/libhm_kernels.so`, which is loaded with
ctypes.  Nothing includes PyTorch's headers, so a full build takes
seconds, not minutes.  The library is rebuilt when any source under
`csrc/` is newer than it.

Each C entry point takes raw device pointers and the CUDA stream (both as
`c_void_p`), launches on that stream, and returns `cudaGetLastError()`;
`Kernel.__call__` raises when that is not 0.  Each `Kernel` counts its
successful launches in `launches`.
"""
import ctypes
import glob
import os
import shutil
import subprocess

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
LIB_PATH = os.path.join(BUILD, "libhm_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_LIB = None


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def stale():
    """True when the library is missing or older than a source."""
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > t for s in _sources())


def build(verbose=False):
    """Compile csrc/*.cu in parallel and link LIB_PATH (atomically
    replaced).  Returns the compilers' output (ptxas lines when verbose)."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    tag = f".tmp{os.getpid()}"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD, os.path.basename(s)[:-3] + tag + ".o")
            for s in srcs]
    procs = [subprocess.Popen(
        [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) +
        ["-c", src, "-o", obj], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        bad = [(s, log) for s, p, log in zip(srcs, procs, logs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(s)}:\n{log}" for s, log in bad))
        tmp = LIB_PATH + tag
        r = subprocess.run([nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp] +
                           objs, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + r.stdout + r.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(logs) + r.stdout + r.stderr


def library():
    """The loaded kernel library, built first if stale."""
    global _LIB
    if _LIB is None:
        if stale():
            build()
        lib = ctypes.CDLL(LIB_PATH)
        lib.hm_error_string.restype = ctypes.c_char_p
        lib.hm_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


P = ctypes.c_void_p
I = ctypes.c_int


class Kernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, name, argtypes):
        self.name = name
        self.argtypes = list(argtypes) + [P]      # + stream
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = library().hm_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check(t, name, dtype, ndim=None, device=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
