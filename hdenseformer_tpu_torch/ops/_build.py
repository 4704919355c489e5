"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every source under ``csrc/`` has a plain C interface, so it compiles without
PyTorch's headers in seconds. ``load_library()`` compiles all sources at once
(one ``nvcc -c`` per source, started together), links them into one shared
library under ``_build/`` (listed in ``.gitignore``), and loads it. The
library's file name carries a hash of the sources and the flags, so an edit
to a kernel builds a new library and an unchanged tree reuses the last one.

Nothing here runs at import: the CPU tests import every module, and a host
without CUDA has no nvcc. A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("dense_attention.cu", "instance_norm_relu.cu", "mha64.cu", "shift_pack.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None
# what the last build's ptxas reported (registers, shared memory, spills)
last_build_log = ""

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, dtype, B, H, N, D, sb, sh, sn, scale, stream
    "hdf_dense_attention": (_p, _p, _p, _p, _i, _i, _i, _i, _i, _ll, _ll, _ll, _f, _p),
    # dtype, D, N
    "hdf_dense_attention_blocks_per_sm": (_i, _i, _i),
    # x, scale, bias, y, part, stats, dtype, vec_bytes, N, S, C, CT, chunk, K, eps,
    # relu, stream
    "hdf_instance_norm_relu": (
        _p, _p, _p, _p, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _f, _i, _p,
    ),
    # x, dy, stats, scale, bias, dx, part, part_floats, tsum, dsb, dtype, vec_bytes,
    # N, S, C, CT, P, grid, relu, stream
    "hdf_instance_norm_relu_bwd": (
        _p, _p, _p, _p, _p, _p, _p, _ll, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _i, _p,
    ),
    # ... as hdf_instance_norm_relu, then npk, stride, period, step (int arrays of 3)
    "hdf_instance_norm_relu_shifted": (
        _p, _p, _p, _p, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _f, _i, _i, _p, _p, _p, _p,
    ),
    # ... as hdf_instance_norm_relu_bwd, then m, npk, stride, period, step
    "hdf_instance_norm_relu_bwd_shifted": (
        _p, _p, _p, _p, _p, _p, _p, _ll, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _i, _f,
        _i, _p, _p, _p, _p,
    ),
    # which, dtype, vec_bytes, shifted, out (int array of 3)
    "hdf_instance_norm_relu_kernel_attributes": (_i, _i, _i, _i, _p),
    # qkv, keep, o, o32, lse, B, H, N, sb, sn, scale, keep_scale, stream
    "hdf_mha64_fwd": (_p, _p, _p, _p, _p, _i, _i, _i, _ll, _ll, _f, _f, _p),
    # qkv, keep, dout, o32, lse, dlt, dqkv, B, H, N, sb, sn, scale, keep_scale, stream
    "hdf_mha64_bwd": (_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _ll, _ll, _f, _f, _p),
    # x, y, forward, vec_bytes, nsp, N, g0, g1, g2, cv, stream
    "hdf_shift_pack": (_p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source on the machine with the GPU"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libhdf_kernels-{digest.hexdigest()[:16]}.so"


def build(out: Path) -> str:
    """Compile every source in parallel and link ``out``; return ptxas's log."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [(name, *p.communicate()) for name, p in zip(SOURCES, procs)]
        for (name, log, _), p in zip(logs, procs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}:\n{log}")
        tmp_lib = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-shared", *objs, "-o", tmp_lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {out.name}:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or nothing
    return "\n".join(f"[csrc/{name}]\n{log}" for name, log, _ in logs)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this tree."""
    global _lib, last_build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                last_build_log = build(path)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
