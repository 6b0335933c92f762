"""Build and load the hand-written CUDA kernels of csrc/.

No counterpart in the JAX package (Pallas kernels compile inside jit).
Every .cu file of csrc/ is compiled with nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes.  The build happens at
first use (never at import: the CPU tests import every module), into
goldpolish_tpu_torch/build/, cached by a hash of the sources and the nvcc
command, so a fresh checkout builds it once per machine.  A failed build
raises; no caller falls back to the plain torch versions for CUDA tensors.

Each wrapper counts its launches in a `LaunchCounter` and each plain
version its calls, so a run can show which path it took.  `to_device` and
`to_host` move a wrapper's host inputs and outputs through pinned memory.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output (-Xptxas -v) of the build this process made


class LaunchCounter:
    """A thread-safe integer count (batches polish on several threads)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build() -> str:
    global build_log
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", CSRC]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"gp_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    # one nvcc per source, all started together, then one link
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    procs = [
        subprocess.Popen([nvcc, *flags, "-c", src, "-o", obj], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    build_log = "".join(p.communicate(timeout=600)[0] for p in procs)
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
                              capture_output=True, text=True, timeout=600)
        build_log += link.stdout + link.stderr
        rcs.append(link.returncode)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if any(rcs):
        raise RuntimeError(f"nvcc failed ({rcs}):\n{build_log}")
    os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    """Load (building if needed) the kernel library; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        L = ctypes.CDLL(_build())
        vp, i32, i64, u64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                  ctypes.c_uint64, ctypes.c_float)
        L.gp_probe_lo32.argtypes = [vp, u64, vp, i64, i32, vp, vp]
        L.gp_probe_lo32.restype = i32
        L.gp_scan_present_packed.argtypes = [
            vp, u64, i32, i32, vp, i64, i64, vp, vp, vp, u64, vp, vp,
        ]
        L.gp_scan_present_packed.restype = i32
        L.gp_scan_present_packed2.argtypes = [
            vp, u64, i32, i32, vp, i64, i64, i64, vp, vp, i64, vp, vp, vp, u64, vp, vp, vp,
        ]
        L.gp_scan_present_packed2.restype = i32
        L.gp_scan_packed2_scratch_bytes.argtypes = [i32, i64, i64]
        L.gp_scan_packed2_scratch_bytes.restype = i64
        L.gp_dbg_bfs.argtypes = [
            vp, u64, i32, i32, u64, vp, vp, vp, vp, vp, i64, i32, i32,
            vp, vp, vp, vp, vp,
        ]
        L.gp_dbg_bfs.restype = i32
        L.gp_dbg_bfs_smem_bytes.argtypes = [i32, i32]
        L.gp_dbg_bfs_smem_bytes.restype = i64
        L.gp_scan_eval.argtypes = [
            vp, u64, i32, i32, i32, i32, i32, f32, f32, i32, i32, i32, i32,
            vp, i64, i64, vp, vp, vp, u64, vp, vp, vp,
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ]
        L.gp_scan_eval.restype = i32
        L.gp_scan_eval_scratch_bytes.argtypes = [i64, i64, i32, i32, i32]
        L.gp_scan_eval_scratch_bytes.restype = i64
        L.gp_bf_count.argtypes = [vp, i64, vp, i64, i32, vp, vp, vp, i32, u64, u64,
                                  vp, vp]
        L.gp_bf_count.restype = i32
        L.gp_bf_promote.argtypes = [vp, i64, vp, i64, vp, i32, i32, vp, vp, vp, i32,
                                    u64, u64, vp, u64, vp, vp]
        L.gp_bf_promote.restype = i32
        L.gp_site_eval.argtypes = [
            vp, u64, i32, i32, vp, i64, vp, i64, vp, vp, vp, u64,
            vp, vp, i32, vp, i32, i32, i32, vp, i32, i32, i32,
            vp, vp, vp, vp, vp, vp,
        ]
        L.gp_site_eval.restype = i32
        L.gp_site_eval_parts_bytes.argtypes = [i64, i32, i32, i32]
        L.gp_site_eval_parts_bytes.restype = i64
        L.gp_dbg_extend.argtypes = [vp, u64, i32, i32, vp, i64, i64, i32, i64, vp,
                                    vp, vp, vp, u64, vp]
        L.gp_dbg_extend.restype = i32
        _LIB = L
        return L


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def to_device(a, device):
    """The numpy array a as a tensor on `device`: for CUDA, staged through
    pinned host memory and copied on the current stream (no wait)."""
    import torch

    a = np.asarray(a)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(a.copy())  # a copy: `a` may be read-only
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = a  # the one host copy
    return pinned.to(device, non_blocking=True)


def to_host(t):
    """The tensor t in host memory: for CUDA, one copy into pinned memory on
    the current stream, waited for; a CPU tensor as it is."""
    import torch

    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return out


def require_cuda(t, name: str) -> None:
    """Raise unless t lies on a CUDA device of a CUDA-enabled torch."""
    import torch

    if t.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"{name}: needs a CUDA tensor, got {t.device}")
