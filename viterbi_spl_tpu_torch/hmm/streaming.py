"""Streaming (fixed-lag) Viterbi decoding for online serving (counterpart
of viterbi_spl_tpu/hmm/streaming.py).

Observations arrive in chunks, the forward DP runs incrementally, and
states are emitted once they are `lag` frames behind the newest
observation, by backtracing from the current best state through the
buffered window.

- With lag >= track length the output equals the offline decode exactly
  (same DP, same first-max tie-breaking).
- With a finite lag, decisions can differ from the offline path only where
  the max-plus recursion has not yet merged within the lag window (the
  convergence the sequence-parallel halo decode relies on,
  dist/sharded_viterbi.py); melody HMMs merge in tens of frames.
- `flush()` emits the remaining tail exactly.

`StreamingViterbiBatch` steps M synchronized streams together through the
batched decode kernels: the banded forward/backtrace (K1/K2) when the
transition structure allows, the dense ones (K3/K4) otherwise; on the CPU
their plain versions. The device decides: there is no switch to another
route. `StreamingViterbi` is a pool of one stream, so that no per-frame
Python loop runs on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .viterbi import log_obs_fn, prepare_log_params
from .viterbi_banded import banded_backtrace, banded_forward, extract_banded_structure
from .viterbi_dense import dense_backtrace, dense_forward


class StreamingViterbiBatch:
    """Fixed-lag streaming decoder for M synchronized concurrent streams (a
    pool of live audio channels stepping in lockstep): one forward launch
    per push for all streams, and one backtrace launch per push that emits.

    - The forward continues each stream exactly by carry injection: the
      carry row is prepended to the chunk as a pseudo-frame decoded against
      a ZERO log prior, and fl(0 + x) == x bitwise, so the kernel's T1
      chain continues the stream's DP exactly.
    - The emission backtrace runs the batched backtrace kernel over the
      buffered window of shifted T1 rows (row j = T1 before frame j).

    The carry and the window stay on the device between pushes.
    push(obs [M, T_c, S]) -> [M, n] int32 states; every stream emits the
    same frame count per push. Per-stream decisions are bit-identical to a
    single stream's, hence equal to the offline decode whenever the lag
    covers the stream.
    """

    def __init__(self, transition_matrix, prob_init, n_streams: int, lag: int = 128,
                 device=None):
        if lag < 1:
            raise ValueError("lag must be >= 1")
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.device = resolve_device(device)
        log_B, log_pi = prepare_log_params(transition_matrix, prob_init)
        self._log_B = torch.from_numpy(log_B).to(self.device)
        self._log_pi = torch.from_numpy(log_pi).to(self.device)
        self._zero_pi = torch.zeros_like(self._log_pi)
        self._bs = extract_banded_structure(np.asarray(transition_matrix, np.float32))
        self.S = log_B.shape[0]
        self.M = n_streams
        self.lag = lag
        self._carry = None  # [M, S] T1 rows after the newest frame
        self._window = None  # [M, B, S] shifted T1 rows of the buffered frames
        self._obs_count = 0
        self._emitted = 0

    def _forward(self, rows: torch.Tensor, log_pi: torch.Tensor):
        lengths = np.full(self.M, rows.shape[1], np.int32)
        if self._bs is not None:
            return banded_forward(self._bs, log_pi, rows, lengths)
        return dense_forward(self._log_B, log_pi, rows, lengths)

    def _emit(self, n: int) -> torch.Tensor:
        window = self._window.contiguous()
        last = torch.argmax(self._carry, dim=1).to(torch.int32)
        lengths = np.full(self.M, window.shape[1], np.int32)
        if self._bs is not None and self._bs.classes:
            states = banded_backtrace(self._bs, window, last, lengths)
        else:
            states = dense_backtrace(self._log_B, window, last, lengths)
        self._window = window[:, n:]
        return states[:, :n]

    def push(self, obs_chunk, is_log: bool = False) -> np.ndarray:
        out = self.push_device(obs_chunk, is_log=is_log)
        if out is None:
            return np.empty((self.M, 0), np.int32)
        return out.cpu().numpy()

    def push_device(self, obs_chunk, is_log: bool = False):
        """push() without the host readback: the emitted states as a tensor
        [M, n] on the pool's device, or None when nothing is ready yet."""
        obs = torch.as_tensor(obs_chunk, dtype=torch.float32).to(self.device)
        if obs.ndim != 3 or obs.shape[0] != self.M or obs.shape[2] != self.S:
            raise ValueError(f"expected [{self.M}, T, {self.S}] observations")
        T_c = obs.shape[1]
        n_ready = max(0, (self._obs_count + T_c - self._emitted) - self.lag)
        if not is_log:
            obs = log_obs_fn(obs)
        # the port keeps no pad lanes: the carry holds exactly S states, so
        # (unlike the JAX kernel path) there is nothing to sanitize before it
        # is injected as a pseudo-frame
        if self._carry is None:
            t1_last, t1m1 = self._forward(obs.contiguous(), self._log_pi)
            self._window = t1m1
        else:
            rows = torch.cat([self._carry[:, None, :], obs], dim=1)
            t1_last, t1m1 = self._forward(rows, self._zero_pi)
            self._window = torch.cat([self._window, t1m1[:, 1:]], dim=1)
        self._carry = t1_last
        self._obs_count += T_c
        self._emitted += n_ready
        return self._emit(n_ready) if n_ready else None

    def flush(self) -> np.ndarray:
        out = self.flush_device()
        if out is None:
            return np.empty((self.M, 0), np.int32)
        return out.cpu().numpy()

    def flush_device(self):
        """flush() without the host readback (a tensor, or None)."""
        if self._carry is None:
            return None
        n = self._obs_count - self._emitted
        if n <= 0:
            return None
        self._emitted += n
        return self._emit(n)


class StreamingViterbi:
    """Fixed-lag streaming decoder for one stream: a StreamingViterbiBatch
    pool of one. push(obs_chunk [T_c, S]) -> [n_emitted] int32 states
    (frames emitted in order); flush() -> the remaining states. Total
    emissions == total frames."""

    def __init__(self, transition_matrix, prob_init, lag: int = 128, device=None):
        self._pool = StreamingViterbiBatch(transition_matrix, prob_init, 1, lag=lag,
                                           device=device)
        self.S = self._pool.S
        self.lag = lag

    def push(self, obs_chunk, is_log: bool = False) -> np.ndarray:
        obs = torch.as_tensor(obs_chunk, dtype=torch.float32)
        if obs.ndim != 2 or obs.shape[1] != self.S:
            raise ValueError(f"expected [T, {self.S}] observations")
        return self._pool.push(obs[None], is_log=is_log)[0]

    def flush(self) -> np.ndarray:
        return self._pool.flush()[0]


class StreamingDrain:
    """Amortized host drain over a StreamingViterbiBatch pool: each push's
    emissions stay on the device, and every `every` pushes they are read
    back in one transfer (a concatenate along the frame axis on the device).

    push(obs) returns None between drain boundaries and the concatenated
    [M, n] states at each boundary; flush() returns everything still
    pending. Per-stream state sequences are identical to per-push draining:
    the wrapper only reorders readbacks, never the DP.
    """

    def __init__(self, pool: StreamingViterbiBatch, every: int = 32):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.pool = pool
        self.every = int(every)
        self._outs: list = []
        self._pushes = 0

    def push(self, obs_chunk, is_log: bool = False):
        out = self.pool.push_device(obs_chunk, is_log=is_log)
        if out is not None:
            self._outs.append(out)
        self._pushes += 1
        if self._pushes % self.every == 0:
            return self._drain()
        return None

    def _drain(self) -> np.ndarray:
        if not self._outs:
            return np.empty((self.pool.M, 0), np.int32)
        cat = torch.cat(self._outs, dim=1)
        self._outs = []
        return cat.cpu().numpy()

    def flush(self) -> np.ndarray:
        tail = self.pool.flush_device()
        if tail is not None:
            self._outs.append(tail)
        return self._drain()
