"""One prepared HMM per (transition matrix, initial probabilities): the
host tables the batch decode APIs derive from them, built once, and their
copies on each card, uploaded once.

A `PreparedHMM` holds
- the host tables: log_B and log_pi (viterbi.prepare_log_params) and the
  banded structure (viterbi_banded.extract_banded_structure), None where
  the matrix has no band;
- per device, their copies there (`card`): log_pi, and the source
  profiles (bv, cls) for K1/K9/K2 where there is a band, else log_B for
  K3/K4.

`prepared_hmm` finds the one for a matrix in a small cache of CACHE_SIZE
entries, the least recently used evicted first, guarded by a lock. The key
is the content: each entry keeps its own float32 copies of A and pi, and a
lookup compares the caller's with np.array_equal (a matrix edited in place
between two calls misses, and is built anew). Comparing costs far less
than hashing the bytes: a hit takes 0.03 ms at 361 states and 0.27 ms at
722 on an H100 host's CPU, where a blake2b of the matrix takes 1-4 ms on a
server CPU and a build 4.3 and 17 ms. An entry equal to the caller's
matrix passed prepare_log_params' validation when it was built, so a hit
skips it.

A lookup runs inside the decode APIs' `decode.prepare` span and counts
`tables_built` where it builds, `tables_reused` where it finds one
(tracing.py).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from .viterbi import prepare_log_params
from .viterbi_banded import BandedStructure, banded_profiles, extract_banded_structure

CACHE_SIZE = 4

_lock = threading.Lock()
_cache: list = []  # PreparedHMMs, the least recently used first


class CardTables(NamedTuple):
    """A prepared HMM's tables on one device."""

    log_pi: torch.Tensor  # [S] f32
    profiles: tuple | None  # (bv, cls) of viterbi_banded.banded_profiles, where there is a band
    log_B: torch.Tensor | None  # [S, S] f32 for K3/K4, where there is none


class PreparedHMM:
    """The decode's tables for one (A, pi), host and card (see the module
    docstring). Build one with `prepared_hmm`."""

    def __init__(self, A: np.ndarray, pi: np.ndarray):
        self.log_B, self.log_pi = prepare_log_params(A, pi)
        self.banded: BandedStructure | None = extract_banded_structure(A)
        self.A, self.pi = A.copy(), pi.copy()
        self._cards: dict = {}

    @property
    def S(self) -> int:
        return self.A.shape[0]

    def matches(self, A: np.ndarray, pi: np.ndarray) -> bool:
        """Whether float32 (A, pi) hold this HMM's content."""
        return np.array_equal(pi, self.pi) and np.array_equal(A, self.A)

    def card(self, device) -> CardTables:
        """The tables on `device`, uploaded at its first call there (as
        `decode.wait` spans)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        tables = self._cards.get(device)
        if tables is None:
            bs = self.banded
            log_pi = tracing.upload(self.log_pi, device, "decode")
            if bs is not None and bs.classes:
                tables = CardTables(log_pi, banded_profiles(bs, device), None)
            else:
                tables = CardTables(log_pi, None, tracing.upload(self.log_B, device, "decode"))
            with _lock:
                tables = self._cards.setdefault(device, tables)
        return tables


def prepared_hmm(transition_matrix, prob_init, hint: PreparedHMM | None = None) -> PreparedHMM:
    """The prepared HMM of (transition_matrix, prob_init), as float32:
    `hint` where it holds the same content, else the cache's entry that
    does, else a new one, built, validated and cached."""
    A = np.asarray(transition_matrix, np.float32)
    pi = np.asarray(prob_init, np.float32)
    if hint is not None and hint.matches(A, pi):
        tracing.count("tables_reused")
        return hint
    with _lock:
        for i, hmm in enumerate(_cache):
            if hmm.matches(A, pi):
                _cache.append(_cache.pop(i))
                tracing.count("tables_reused")
                return hmm
    built = PreparedHMM(A, pi)
    tracing.count("tables_built")
    with _lock:
        # another thread may have built the same meanwhile: keep one
        hmm = next((h for h in _cache if h.matches(built.A, built.pi)), built)
        if hmm is built:
            _cache.append(built)
            del _cache[:-CACHE_SIZE]
    return hmm


def cached() -> list[PreparedHMM]:
    """The cache's entries, the least recently used first."""
    with _lock:
        return list(_cache)


def clear() -> None:
    """Empty the cache."""
    with _lock:
        _cache.clear()
