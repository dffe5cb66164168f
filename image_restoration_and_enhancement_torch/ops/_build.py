"""Build and load the port's CUDA kernels: nvcc, a plain-C library, ctypes.

Every source in ``csrc/`` is compiled to an object by its own
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c``
process, all started together, and one more nvcc call links the objects into a
shared library in ``_build/`` inside the package (listed in ``.gitignore``).
The library name carries a hash of the flags and of every file in ``csrc/``
(the sources and the headers they include), so an edited file is rebuilt and
an unchanged one is loaded as it is. No PyTorch headers are compiled in: each
kernel has an ``extern "C"`` launcher that takes raw pointers, sizes and
strides and a ``cudaStream_t``, and returns ``cudaGetLastError()``.

A failed build raises ``KernelError``, and so does a launcher that returns
non-zero; nothing here falls back to the plain PyTorch versions, and callers
that catch errors to serve a fallback let ``KernelError`` through.

``launch_counts`` counts kernel launches by kernel name; a wrapper increments it
right after a launch succeeds and nowhere else. ``launch_shapes`` records the
same launches keyed by (kernel, shape description), so a caller can replay the
shapes a run used, and ``launch_paths`` keyed by (kernel, path) for the kernels
with more than one device code (the attention kernels: ``ops/attention.py``'s
``kernel_path``; K4: its ``int8_kernel_path``; K2: ``ops/groupnorm.py``'s
``plan``; K3: ``ops/conv_int8.py``'s ``conv_path``), so a run can show which
code served.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("attention.cu", "groupnorm.cu", "conv_int8.cu", "int8_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: "collections.Counter[str]" = collections.Counter()
launch_shapes: "collections.Counter[Tuple[str, tuple]]" = collections.Counter()
launch_paths: "collections.Counter[Tuple[str, str]]" = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, object] = {}
# What the last build in this process did: seconds, library path, compiler log.
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    # dtype, path, q, k, v, o, B, H, Nq, Nk, D, q strides (b, n, h), k strides,
    # v strides, scale, flags, stream
    "iret_attention": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P],
    # as iret_attention, without flags
    "iret_flash_attention": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    # dtype, path, q, k, v, o, B, H, Nq, Nk, D, q strides (b, n), k strides,
    # v strides, scale, stream
    "iret_packed_attention": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _F, _P],
    "iret_packed_attention_grid": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _F, _P],
    # path, dtype, wdtype, x, scale, bias, y, B, HW, C, G, rows_per_block, eps,
    # silu, stream
    "iret_group_norm": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # dtype, x, partials, B, HW, C, G, rows_per_block, stream
    "iret_group_norm_stats": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, wdtype, x, scale, bias, partials, nparts, y, B, HW, C, G,
    # rows_per_block, count, eps, silu, stream
    "iret_group_norm_apply": [_I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                              _P],
    # path, out dtype, x, w, scale, out, split-K workspace, tile counters, B, H,
    # W, C, N, splits, stream
    "iret_conv3x3_int8": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # path, v dtype, q8, k8, v, scale, o, B, H, Nq, Nk, D, q8 strides (b, n, h),
    # k8 strides, v strides, stream
    "iret_int8_attention": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L, _P],
}


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


def record_launch(kernel: str, shape: tuple, path: Optional[str] = None) -> None:
    """Count one launch of ``kernel`` (called by a wrapper after its launch),
    and of its ``path`` where it has more than one."""
    launch_counts[kernel] += 1
    launch_shapes[(kernel, shape)] += 1
    if path is not None:
        launch_paths[(kernel, path)] += 1


def reset_launch_counts() -> None:
    launch_counts.clear()
    launch_shapes.clear()
    launch_paths.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def _source_hash() -> str:
    """A hash of the flags and of every file under ``csrc/`` (the sources and
    the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile(out_path: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out_path}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
            for src, obj in zip(SOURCES, objs)]
    cmds.append([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", f"{tmp}.so", *objs])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    log = ""
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        proc = subprocess.run(cmds[-1], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(f"nvcc link failed ({proc.returncode}):\n"
                              f"{' '.join(cmds[-1])}\n{proc.stdout}{proc.stderr}")
        os.replace(f"{tmp}.so", out_path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use and then cached."""
    global _lib
    with _lock:
        if _lib is None:
            path = os.path.join(BUILD_DIR, f"libiret_kernels_{_source_hash()}.so")
            t0 = time.perf_counter()
            built = not os.path.exists(path)
            log = _compile(path) if built else ""
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load the kernels library {path}: {e}") from e
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.iret_error_string.argtypes = [ctypes.c_int]
            lib.iret_error_string.restype = ctypes.c_char_p
            build_info.update(
                seconds=time.perf_counter() - t0, path=path, log=log, built=built
            )
            _lib = lib
        return _lib


def raw_stream(device_index: int) -> int:
    """PyTorch's current stream on a CUDA device as a ``cudaStream_t`` (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without building a
    Stream object: a wrapper's host time counts in every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


def entry(name: str):
    """The C entry ``name`` of the library (built at first use)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    return fn


def check(err: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        name = library().iret_error_string(err).decode()
        raise KernelError(f"{kernel} kernel launch failed: cudaError {err} ({name})")
