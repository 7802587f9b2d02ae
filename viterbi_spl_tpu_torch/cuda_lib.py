"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc, at first use, into a shared
library with a plain C interface under `_build/` (listed in .gitignore),
named by a hash of the sources and flags so that an edited source is
rebuilt. The libraries are loaded with ctypes: every pointer and the CUDA
stream pass as `c_void_p`, and each C entry returns `cudaGetLastError()`,
which `check` turns into an exception.

Nothing is built or loaded when this module is imported: the CPU tests
import every module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("viterbi_banded", "viterbi_dense")
# sm_90a, -O3, and deliberately no --use_fast_math: the decoders must stay
# bit-exact. -Xptxas -v writes each kernel's registers and spills to the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns {name: build log}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        logs[name] = log
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use.
    signatures: {C function: argtypes}; every function returns an int."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.vspl_error_string.argtypes = [ctypes.c_int]
        lib.vspl_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.vspl_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def host_lengths(lengths, N: int, T: int) -> np.ndarray:
    """Validated per-track lengths as host int32 (1 <= len <= T): a kernel
    trusts them as loop bounds."""
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    lengths = np.asarray(lengths, np.int32)
    if lengths.shape != (N,) or lengths.min() < 1 or lengths.max() > T:
        raise ValueError(f"lengths must be [N={N}] in [1, T={T}], got {lengths}")
    return lengths


def cuda_operand(x: torch.Tensor, name: str, dtype=torch.float32) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {x.dtype}")
    return x


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
