"""Native CPU runtime components, C++ loaded with ctypes (counterpart of
viterbi_spl_tpu/native/__init__.py).

The reference ships one native module, a Numba-AOT-compiled Viterbi core
(the .so built by dcnet/aot_viterbi_core.py). Here the equivalent is a
small C++ library, this package's own copy of the JAX package's source,
built with g++ at first use (`build_native()`) and exposing:

- viterbi_core      — probability-domain CPU decode (oracle-exact),
- viterbi_core_log  — log-domain variant (the decoders' float32 log
                      operands, `hmm/viterbi.py::prepare_log_params`),
- backtrace         — standalone pointer chase.

This is the CPU reference decoder: it runs on the host whatever device the
rest of a run uses, and it is no fallback for the CUDA kernels.
`viterbi_native_fn` mirrors the reference wrapper viterbi_numba_fn
(dcnet/tf_viterbi_decoding.py:119-153): validates stochasticity, transposes
to the C layout, and returns int64 states.

Each source builds into `_build/lib<stem>-<hash>.so` (listed in
.gitignore), named by a hash of the source, the flags and the host CPU's
feature flags (-march=native code runs only where it was built), so that
an edited source or another host rebuilds; nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_THIS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _THIS_DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lib = None


def _host_cpu_flags() -> bytes:
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    return next((ln for ln in lines if ln.startswith(("flags", "Features"))), "").encode()


def library_path(source: str) -> Path:
    src = _THIS_DIR / source
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu_flags())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_native(source: str = "viterbi_native.cpp") -> Path:
    """Build (on demand) one of this package's C++ sources into its library
    under _build/ and return the library's path; raises with the
    compiler's output if g++ fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, str(_THIS_DIR / source), "-o", str(tmp), "-lpthread"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.viterbi_core.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.viterbi_core.restype = ctypes.c_int32
    lib.viterbi_core_log.argtypes = list(lib.viterbi_core.argtypes)
    lib.viterbi_core_log.restype = ctypes.c_int32
    lib.backtrace.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.backtrace.restype = ctypes.c_int32
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def viterbi_native_fn(*, transition_matrix, prob_init, probs_st) -> np.ndarray:
    """Native decode with the reference wrapper's validation semantics
    (dcnet/tf_viterbi_decoding.py:119-153). probs_st is [S, T]."""
    lib = _load()
    B = np.asarray(transition_matrix)
    probs = np.asarray(probs_st)
    S, T = probs.shape
    if B.shape != (S, S):
        raise ValueError("transition matrix shape mismatch")
    if not np.allclose(B.sum(axis=1), 1.0):
        raise ValueError("transition matrix rows must sum to 1")
    if not np.isclose(np.asarray(prob_init).sum(), 1.0):
        raise ValueError("prob_init must sum to 1")

    Bt = np.require(B.T, np.float32, ["C"])
    pi = np.require(prob_init, np.float32, ["C"])
    obs = np.require(probs.T, np.float32, ["C"])
    out = np.empty(T, np.int64)
    rc = lib.viterbi_core(Bt, pi, obs, S, T, out)
    if rc != 0:
        raise RuntimeError(f"viterbi_core failed with code {rc}")
    return out


def viterbi_native_log_fn(log_B, log_pi, log_obs) -> np.ndarray:
    """Log-domain native decode: log_B [S, S] (= log A.T), log_pi [S],
    log_obs [T, S] time-major. Returns [T] int64."""
    lib = _load()
    log_B = np.require(log_B, np.float32, ["C"])
    log_pi = np.require(log_pi, np.float32, ["C"])
    log_obs = np.require(log_obs, np.float32, ["C"])
    T, S = log_obs.shape
    out = np.empty(T, np.int64)
    rc = lib.viterbi_core_log(log_B, log_pi, log_obs, S, T, out)
    if rc != 0:
        raise RuntimeError(f"viterbi_core_log failed with code {rc}")
    return out


def backtrace_native(T2: np.ndarray, last_state: int) -> np.ndarray:
    """The pointer chase over a backpointer table T2 [T, S] from
    `last_state`. Returns [T] int64."""
    lib = _load()
    T2 = np.require(T2, np.int32, ["C"])
    T, S = T2.shape
    out = np.empty(T, np.int64)
    rc = lib.backtrace(T2, T, S, int(last_state), out)
    if rc != 0:
        raise RuntimeError(f"backtrace failed with code {rc}")
    return out
