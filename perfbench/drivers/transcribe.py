"""Transcribe traffic: a closed loop over a catalogue of tracks, one track a
request, as a user runs cli/transcribe.py with its default --method shaun:

1. cli.transcribe.features_from_samples (the CFP on the card),
2. apps.common.model_logits_for_dataset with the model loaded once in
   set-up (a track's chunks in one batch, normalized by their own
   statistics),
3. DecoderSetup.decode_batch (the observation model, K1 -> K2),

voiced flags and bins out. The catalogue is a pool of synthetic melody
tracks (traffic.melody_audio) at the traffic file's lengths, cycled if the
window outruns it; its lengths and their order are the same for every
seed. The window ends with the track in flight when --seconds runs out,
counted whole with its time. Set-up loads the model with weights made on
the card from the seed and transcribes the whole pool once, so that every
shape the window meets is warm.

After the window the reference (CFP, TONet, observation model, Viterbi)
transcribes a sample of the served tracks: the longest and others drawn
from the seed. Numbers compared: `logit_gap`, the largest difference of a
logit over the reference's largest magnitude (worst track), and
`path_gap`, how far the program's path scores below the reference's best
under the reference's own observations (nats a frame, worst track).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import hmm_params, traffic as T, work
from ..reference import cfp as ref_cfp, decode as ref_dec, tonet as ref_tonet
from ..reference.precision import CONTROL, EXACT, matmul_precision
from ..weights import make_weights
from . import View


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.hmm = config["hmm"]
        self.sr = int(config["frontend"]["sr"])
        self.hop = int(config["frontend"]["hop_size"])
        self.attempted = self.failed = 0

    def _ref_model(self):
        with torch.device("meta"):
            return ref_tonet.TONet(**self.config["model_kwargs"])

    def setup(self):
        from viterbi_spl_tpu_torch.apps import common, tonet as tonet_app
        from viterbi_spl_tpu_torch.cli import transcribe
        from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup

        self.common, self.transcribe = common, transcribe
        self.cfg = tonet_app.config()
        with torch.device("meta"):
            model = self.cfg.make_model(dtype=self.cfg.compute_dtype, **self.config["model_kwargs"])
        self.model = model.to_empty(device=self.device)
        self.model.load_state_dict(make_weights(self._ref_model(), self.seed, self.device),
                                   strict=True)
        self.model.eval()

        h = self.hmm
        n_bins = int(h["n_bins"])
        switch = None if h["switch"] == "counted" else h["switch"]
        self.A, self.pi = hmm_params.shaped_hmm(n_bins, int(h["d_max"]), int(h["floor"]), switch,
                                                self.seed)
        self.threshold = float(self.traffic["voicing_threshold"])
        self.setup_ = DecoderSetup(
            transition_matrix=self.A, init_probs=self.pi, n_bins=n_bins,
            note_min=float(ref_tonet.note_range()[0]), bins_per_semitone=5.0, spw=int(h["spw"]),
            voicing_threshold=self.threshold, hop_seconds=self.hop / self.sr, method="shaun",
            obs_p=float(h["obs_p"]), obs_scale=float(h["obs_scale"]), device=self.device)

        # the same lengths in the same order for every seed: the window
        # covers only part of the pool, and the seed changes the content
        self.frames = [int(f) for f in T.track_lengths(self.traffic["lengths"],
                                                        int(self.traffic["pool_tracks"]))]
        self.audio = [T.melody_audio(f * self.hop / self.sr, self.sr, T.sub_seed(self.seed, 7, i),
                                     self.device) for i, f in enumerate(self.frames)]
        for samples in self.audio:
            self._request(samples, None)

    def _request(self, samples, rec):
        span = rec.span if rec is not None else (lambda name: contextlib.nullcontext())
        with span("front_end"):
            feat = self.transcribe.features_from_samples("tonet", samples, device=self.device)
        with span("model"):
            logits = self.common.model_logits_for_dataset(
                self.cfg, self.model, self.transcribe._WavDataset(["track"], [feat]))[0]
        with span("decode"):
            voiced, bins = self.setup_.decode_batch([logits])[0]
        return logits, voiced, bins

    def run(self, seconds: float, rec) -> dict:
        self.records, self.outputs = [], []
        audio_s, k = 0.0, 0
        rec.open()
        while True:
            i = k % len(self.audio)
            k += 1
            t0 = time.perf_counter()
            logits, voiced, bins = self._request(self.audio[i], rec)
            t1 = time.perf_counter()
            self.attempted += 1
            audio_s += len(self.audio[i]) / self.sr
            self.records.append({"track": i, "frames": len(logits), "t0": t0, "t1": t1})
            self.outputs.append((i, logits, np.where(voiced, bins, len(self.pi) - 1)))
            if t1 - rec.window_start >= seconds:
                break
        rec.close()
        return {"transcribe_rate": audio_s / rec.window_s}

    def layer_view(self, rec) -> View:
        extra = {"flops_per_frame": work.tonet_flops_per_frame(self.config["model_kwargs"]),
                 "frames": sum(r["frames"] for r in self.records)}
        return View(rec, self.config, self.traffic, self.records, extra)

    def release(self):
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def _sample(self) -> list[int]:
        """Output indices: the longest served track and others drawn from
        the seed (distinct tracks)."""
        rng = np.random.default_rng(T.sub_seed(self.seed, 8))
        first = {}
        for k, (i, _, _) in enumerate(self.outputs):
            first.setdefault(i, k)
        ks = list(first.values())
        longest = max(ks, key=lambda k: len(self.outputs[k][1]))
        others = [k for k in rng.permutation(ks) if k != longest]
        return [longest] + [int(k) for k in others[: int(self.traffic["check"]["tracks"]) - 1]]

    def _reference(self, samples, precision):
        """(logits [T, 360], path [T]) of the reference at `precision`."""
        fe = self.config["frontend"]
        cfg = ref_cfp.CFPConfig(sr=self.sr, win_len=int(fe["win_len"]), hop_size=self.hop,
                                fmin=float(fe["fmin"]), fmax=float(fe["fmax"]))
        feat = ref_cfp.cfp_features(cfg, samples, self.device, precision).permute(0, 2, 1)
        Tn = feat.shape[0]
        seg = int(self.config["model_kwargs"]["seg_frame"])
        n = -(-Tn // seg)
        chunks = torch.zeros((n * seg, *feat.shape[1:]), device=self.device)
        chunks[:Tn] = feat
        chunks = chunks.reshape(n, seg, *feat.shape[1:]).permute(0, 2, 3, 1)
        if not hasattr(self, "_ref_weights"):
            self._ref_weights = make_weights(self._ref_model(), self.seed, self.device)
        model = self._ref_model().to_empty(device=self.device)
        model.load_state_dict(self._ref_weights, strict=True)
        with torch.no_grad(), matmul_precision(precision):
            logits = ref_tonet.pitch_logits(model.eval()(chunks, batch_stats=True))
        logits = logits.reshape(-1, logits.shape[-1])[:Tn]
        h = self.hmm
        th = float(np.log(self.threshold / (1 - self.threshold)))
        log_obs = ref_dec.shaun_log_obs(logits, th, int(h["spw"]), float(h["obs_p"]),
                                        float(h["obs_scale"]), precision)
        log_B, log_pi = self._tables()
        return logits, log_obs, ref_dec.viterbi(log_B, log_pi, [log_obs])[0]

    def _tables(self):
        log_B, log_pi = ref_dec.log_params(self.A, self.pi)
        return torch.from_numpy(log_B).to(self.device), torch.from_numpy(log_pi).to(self.device)

    def control(self) -> dict:
        """The reference one precision step down: CFP in float32, TONet
        with TF32, the observation model in bfloat16."""
        out = {}
        for k in self._sample():
            logits, _, path = self._reference(self.audio[self.outputs[k][0]], CONTROL)
            out[k] = (logits.cpu().numpy(), path.numpy())
        return out

    def check(self, candidate: dict | None = None) -> dict:
        log_B, log_pi = self._tables()
        logit_gaps, path_gaps = [], []
        for k in self._sample():
            i, logits, path = self.outputs[k]
            if candidate is not None:
                logits, path = candidate[k]
            ref_logits, log_obs, best = self._reference(self.audio[i], EXACT)
            got = torch.as_tensor(np.asarray(logits), device=self.device)
            if got.shape != ref_logits.shape:
                return {"logit_gap": float("inf"), "path_gap": float("inf")}
            logit_gaps.append(float((got - ref_logits).abs().max() / ref_logits.abs().max()))
            path_gaps.append(ref_dec.path_gap(log_B, log_pi, log_obs, best,
                                              torch.as_tensor(np.asarray(path))))
        return {"logit_gap": max(logit_gaps), "path_gap": max(path_gaps)}

