"""Native snippet prefetch loader: a C++ thread-pool ring, ctypes
(counterpart of viterbi_spl_tpu/native/prefetch.py).

The runtime role the reference gives tf.data's `.prefetch(10)`
(dcnet/softmax_viterbi.py:649-656): batch assembly runs ahead of the
training loop on native threads. Each batch is two contiguous regions in a
ring slot (stacked spectrogram snippets and stacked note labels) filled
by GIL-free memcpys from the immutable precomputed track arrays.

Sampling semantics match `data.snippets.training_snippets` restricted to
full-length snippets (the per-epoch `rng.permutation` over the snippet
index), so a seeded run is reproducible against the Python pipeline.
The ring lives on the host; `apps/common.py::training_batches` puts its
batches on the device.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..data.registry import TrackDataset
from ..data.snippets import snippet_index
from . import build_native

_DESC_DTYPE = np.dtype(
    [
        ("src", np.uint64),
        ("src_off", np.uint64),
        ("n_bytes", np.uint64),
        ("dst_off", np.uint64),
    ]
)


def _ring_lib():
    lib = ctypes.CDLL(str(build_native("prefetch_ring.cpp")))
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.ring_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.ring_pop.restype = ctypes.c_void_p
    lib.ring_pop.argtypes = [ctypes.c_void_p]
    lib.ring_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    return lib


class SnippetPrefetcher:
    """Infinite stream of (spectrogram [B, L, ...], notes [B, L]) float32
    NumPy batches.

    By default each batch is copied out of its ring slot before the slot is
    released (one contiguous memcpy: the ring's win is the GIL-free
    scatter-gather of snippets on worker threads, not this copy), so the
    consumer owns it and may hand it to an asynchronous device copy. With
    zero_copy=True the yielded arrays are views into the ring slot and stay
    valid only until the NEXT batch is requested; the consumer must have
    fully read them by then (np.copy, or a device copy it has waited for:
    `torch.from_numpy(view).to(device, non_blocking=True)` alone is not
    enough, since the copy may land after the slot is refilled).
    `python_reference_batches` reproduces the exact stream in pure Python
    for testing. A dataset with no full-length snippet raises ValueError; a
    failed build or load of the ring raises.
    """

    def __init__(
        self,
        dataset: TrackDataset,
        snippet_len: int,
        batch_size: int,
        rng: np.random.Generator,
        *,
        slots: int = 4,
        threads: int = 2,
        zero_copy: bool = False,
    ):
        self._zero_copy = zero_copy
        self.snippet_len = snippet_len
        self.batch_size = batch_size
        self._rng = rng
        self._ring = None
        # full-length snippets only (fixed-size ring buffers)
        self._index = [
            (r, s)
            for r, s, e in snippet_index(dataset, snippet_len)
            if e - s == snippet_len
        ]
        if not self._index:
            raise ValueError("no full-length snippets in dataset")
        # keep references so the descriptor sources stay alive
        self._specs = [
            np.ascontiguousarray(t.spectrogram, np.float32) for t in dataset.tracks
        ]
        self._notes = [
            np.ascontiguousarray(t.notes, np.float32) for t in dataset.tracks
        ]
        feat = self._specs[0].shape[1:]
        self._spec_shape = (batch_size, snippet_len, *feat)
        self._spec_bytes = int(np.prod(self._spec_shape)) * 4
        self._notes_shape = (batch_size, snippet_len)
        self._notes_bytes = batch_size * snippet_len * 4
        self._row_bytes = int(np.prod(feat)) * 4

        self._lib = _ring_lib()
        self._ring = self._lib.ring_create(
            slots, self._spec_bytes + self._notes_bytes, threads
        )
        self._slots = slots

    def _plan(self):
        """Infinite (rec_idx, start) stream: per-epoch permutation."""
        while True:
            for i in self._rng.permutation(len(self._index)):
                yield self._index[i]

    def _descs_for(self, items) -> np.ndarray:
        descs = np.empty(2 * len(items), _DESC_DTYPE)
        for b, (rec, start) in enumerate(items):
            spec = self._specs[rec]
            descs[b] = (
                spec.ctypes.data,
                start * self._row_bytes,
                self.snippet_len * self._row_bytes,
                b * self.snippet_len * self._row_bytes,
            )
            notes = self._notes[rec]
            descs[len(items) + b] = (
                notes.ctypes.data,
                start * 4,
                self.snippet_len * 4,
                self._spec_bytes + b * self.snippet_len * 4,
            )
        return descs

    def __iter__(self):
        plan = self._plan()
        in_flight = 0
        held_ptr = None
        while True:
            while in_flight < self._slots - (1 if held_ptr is not None else 0):
                items = [next(plan) for _ in range(self.batch_size)]
                descs = self._descs_for(items)
                self._lib.ring_submit(self._ring, descs.ctypes.data, len(descs))
                in_flight += 1
            ptr = self._lib.ring_pop(self._ring)
            in_flight -= 1
            buf = (ctypes.c_uint8 * (self._spec_bytes + self._notes_bytes)).from_address(ptr)
            arr = np.frombuffer(buf, np.float32)
            spec = arr[: self._spec_bytes // 4].reshape(self._spec_shape)
            notes = arr[self._spec_bytes // 4:].reshape(self._notes_shape)
            if not self._zero_copy:
                # own the data before the slot can be refilled by a worker
                spec, notes = spec.copy(), notes.copy()
                self._lib.ring_release(self._ring, ptr)
                yield spec, notes
                continue
            if held_ptr is not None:
                self._lib.ring_release(self._ring, held_ptr)
            held_ptr = ptr
            yield spec, notes

    def python_reference_batches(self, rng: np.random.Generator):
        """The same stream computed in pure Python (for tests)."""
        index = self._index
        batch = []
        while True:
            order = rng.permutation(len(index))
            for i in order:
                batch.append(index[i])
                if len(batch) == self.batch_size:
                    spec = np.stack(
                        [self._specs[r][s: s + self.snippet_len] for r, s in batch]
                    )
                    notes = np.stack(
                        [self._notes[r][s: s + self.snippet_len] for r, s in batch]
                    )
                    yield spec, notes
                    batch = []

    def close(self):
        if self._ring is not None:
            self._lib.ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
