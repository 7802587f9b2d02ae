"""Decode traffic: a closed loop of batched decode requests, one at a time,
as a user runs cli/decode.py over a catalogue of posteriorgrams.

A request is `batch` zero-padded tracks of synthetic logits [N, T_max,
n_bins] already on the card, decoded by the program's batched decode API
(hmm.viterbi_dense.viterbi_decode_batch_fused_obs, the observation model
of DecoderSetup.obs_config()), the states copied to the host. The pool holds
`pool_requests` distinct requests, replayed in a seeded order; their
lengths are the traffic file's, the same for every seed. The rate is all real
frames over all the window's time.

The window keeps, of each pool request, one served replay drawn from the
seed (a reservoir of one). After the window, `check.requests` of these,
drawn from the seed, are decoded again by the reference
(reference/decode.py), every track of each. The number compared,
`path_gap`, is how far the program's path scores below the reference's
best under the reference's own observations (nats a frame, the worst
track).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import hmm_params, traffic as T, work
from ..reference import decode as ref
from ..reference.precision import CONTROL, EXACT
from . import View


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.hmm = config["hmm"]
        self.attempted = self.failed = 0

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup
        from viterbi_spl_tpu_torch.hmm import viterbi_dense

        h = self.hmm
        n_bins = int(h["n_bins"])
        switch = None if h["switch"] == "counted" else h["switch"]
        self.A, self.pi = hmm_params.shaped_hmm(n_bins, int(h["d_max"]), int(h["floor"]), switch,
                                                self.seed)
        setup = DecoderSetup(
            transition_matrix=self.A, init_probs=self.pi, n_bins=n_bins, note_min=0.0,
            bins_per_semitone=1.0, spw=int(h["spw"]),
            voicing_threshold=float(h["voicing_threshold"]), hop_seconds=0.01,
            method="shaun", obs_p=float(h["obs_p"]), obs_scale=float(h["obs_scale"]),
            device=self.device)
        self.obs = setup.obs_config()
        self.decode_fn = viterbi_dense.viterbi_decode_batch_fused_obs

        batch, n_pool = int(self.traffic["batch"]), int(self.traffic["pool_requests"])
        lengths = T.track_lengths(self.traffic["lengths"], batch * n_pool)
        rng = np.random.default_rng(T.sub_seed(self.seed, 6))
        self.lengths = [rng.permutation(lengths[i: i + batch]).astype(np.int32)
                        for i in range(0, len(lengths), batch)]
        self.pool = [T.logits_batch(self.traffic["logits"], n_bins, L, T.sub_seed(self.seed, 7, i),
                                    self.device) for i, L in enumerate(self.lengths)]
        self.order = rng.permutation(len(self.pool))
        for i in range(len(self.pool)):  # every request shape once: kernels built and loaded
            self._decode(i)

    def _decode(self, i: int) -> np.ndarray:
        states = self.decode_fn(transition_matrix=self.A, prob_init=self.pi, logits=self.pool[i],
                                lengths=self.lengths[i], obs=self.obs)
        return states.cpu().numpy()

    # -- the window --------------------------------------------------------
    def run(self, seconds: float, rec) -> dict:
        self.records = []
        # pool index -> [replays served, the kept replay's states]
        self.outputs: dict[int, list] = {}
        keep = np.random.default_rng(T.sub_seed(self.seed, 8))
        frames, k = 0, 0
        rec.open()
        while True:
            i = int(self.order[k % len(self.order)])
            k += 1
            t0 = time.perf_counter()
            with rec.span("request"):
                states = self._decode(i)
            t1 = time.perf_counter()
            self.attempted += 1
            frames += int(self.lengths[i].sum())
            self.records.append({"pool": i, "t0": t0, "t1": t1})
            kept = self.outputs.setdefault(i, [0, None])
            kept[0] += 1
            if keep.random() * kept[0] < 1.0:
                kept[1] = states
            if t1 - rec.window_start >= seconds:
                break
        rec.close()
        return {"decode_rate": frames / rec.window_s}

    def layer_view(self, rec) -> View:
        h = self.hmm
        S, spw = int(h["n_bins"]) + 1, int(h["spw"])
        peaks = {}
        for i in {r["pool"] for r in self.records}:
            peaks[i] = sum(int(ref.find_peaks(self.pool[i][j, :L], spw).sum())
                           for j, L in enumerate(self.lengths[i]))
        rows = []
        for r in self.records:
            i = r["pool"]
            args = (S, int(h["d_max"]), spw, self.lengths[i], peaks[i])
            rows.append(dict(r, lengths=self.lengths[i], peaks=peaks[i],
                             forward_s=work.fused_forward_bound(*args),
                             backtrace_s=work.bound(*work.backtrace_work(S, self.lengths[i])),
                             decode_s=work.decode_bound(*args)))
        return View(rec, self.config, self.traffic, rows, {})

    def release(self):
        self.decode_fn = None

    # -- the check ---------------------------------------------------------
    def _sample(self) -> list[int]:
        """Pool indices of served requests drawn from the seed; the check
        reads the kept replay of each, every track."""
        rng = np.random.default_rng(T.sub_seed(self.seed, 9))
        served = sorted(self.outputs)
        n = min(int(self.traffic["check"]["requests"]), len(served))
        return sorted(int(p) for p in rng.choice(served, size=n, replace=False))

    def _log_obs(self, i, tracks, precision):
        h = self.hmm
        th = float(np.log(h["voicing_threshold"] / (1 - h["voicing_threshold"])))
        return [ref.shaun_log_obs(self.pool[i][j, : self.lengths[i][j]], th, int(h["spw"]),
                                  float(h["obs_p"]), float(h["obs_scale"]), precision)
                for j in tracks]

    def control(self) -> dict:
        """The reference's paths with the observation model in bfloat16."""
        log_B, log_pi = self._tables()
        out = {}
        for i in self._sample():
            tracks = range(len(self.lengths[i]))
            paths = ref.viterbi(log_B, log_pi, self._log_obs(i, tracks, CONTROL))
            out.update({(i, j): p for j, p in zip(tracks, paths)})
        return out

    def _tables(self):
        log_B, log_pi = ref.log_params(self.A, self.pi)
        return torch.from_numpy(log_B).to(self.device), torch.from_numpy(log_pi).to(self.device)

    def check(self, candidate: dict | None = None) -> dict:
        log_B, log_pi = self._tables()
        gaps = []
        for i in self._sample():
            tracks = range(len(self.lengths[i]))
            obs = self._log_obs(i, tracks, EXACT)
            best = ref.viterbi(log_B, log_pi, obs)
            for j, o, b in zip(tracks, obs, best):
                L = int(self.lengths[i][j])
                got = (torch.as_tensor(self.outputs[i][1][j, :L]) if candidate is None
                       else candidate[(i, j)])
                gaps.append(ref.path_gap(log_B, log_pi, o, b, got))
        return {"path_gap": max(gaps)}
