# -*- coding: utf-8 -*-
"""Builds and loads the port's CUDA kernels.

Every source under `csrc/` is compiled by nvcc for sm_90a into a plain-C
shared library in `fddm_asr_tpu_torch/_build/` (gitignored) and loaded with
ctypes; all sources are started together, one nvcc each, at the first
launch of any kernel (or by `build_libraries`, which `chip_smoke.py` calls
to time the build).  A library's file name carries a hash of its source,
the shared headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.

The kernel modules (`flash_attention`, `quant`, `conv_frontend`) declare
their C functions with `register` and launch them with `launch`, which
passes PyTorch's current stream and raises when the launch is refused.
Nothing here falls back to a plain version.

Each inference entry point is also a `torch.library.custom_op` in the
`fddm` namespace (`torch.ops.fddm.*`), so that `torch.export` records the
kernel as one node of its program.  Eager calls go to the launcher
directly; only a trace (`tracing()`) records the op, whose implementation
is the same device-routed function.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = {"gated_attention": "gated_attention.cu",
           "gated_attention_bwd": "gated_attention_bwd.cu",
           "int8_matmul_fused": "int8_matmul_fused.cu",
           "conv_ln_gelu": "conv_ln_gelu.cu"}
HEADERS = ("gated_attention.cuh", "tile_ops.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_signatures: Dict[str, Tuple[str, List]] = {}  # C function -> (library, argtypes)
_libs: Dict[str, ctypes.CDLL] = {}             # loaded on first CUDA call


def register(fn_name: str, library: str, argtypes: List) -> None:
    """Declare a C function `int fn(argtypes..., void* stream)` of `library`."""
    _signatures[fn_name] = (library, [*argtypes, P])


def tracing() -> bool:
    """True while `torch.export` (or `torch.compile`) traces: the kernel
    wrappers then record their `torch.ops.fddm` op and keep no cache."""
    return torch.compiler.is_compiling()


def _source_digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_source_digest(name)}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build the CUDA kernels")
    return nvcc


def build_libraries(verbose: bool = False) -> Dict[str, str]:
    """Compile every source in csrc/ for sm_90a, one nvcc per source, all
    started together; returns {name: .so path}.  `verbose` prints what ptxas
    says of each kernel (registers, shared memory, spills)."""
    paths = {name: _library_path(name) for name in SOURCES}
    todo = {name: path for name, path in paths.items() if not os.path.exists(path)}
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {SOURCES[name]} ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err.strip())
        os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _function(fn_name: str):
    lib_name, _ = _signatures[fn_name]
    if lib_name not in _libs:
        lib = ctypes.CDLL(build_libraries()[lib_name])
        for name, (owner, types) in _signatures.items():
            if owner == lib_name:
                getattr(lib, name).argtypes = types
                getattr(lib, name).restype = ctypes.c_int
        _libs[lib_name] = lib
    return getattr(_libs[lib_name], fn_name)


def launch(fn_name: str, dev: torch.device, *args) -> None:
    """Call a registered C function on `dev`'s current stream; raises if the
    launch was refused (the function returns cudaGetLastError())."""
    fn = _function(fn_name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def check_tensor(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    """The kernels take contiguous, 16-byte aligned tensors of one device."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels load 16-byte rows)")
