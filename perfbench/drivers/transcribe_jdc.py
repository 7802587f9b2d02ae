"""JDC transcription traffic: a closed loop over a pool of clips, one clip a
request, as a user runs `cli/transcribe.py --family jdc` with its default
--method shaun:

1. cli.transcribe.features_from_samples("jdc") (the STFT on the card, its
   dB scaling on the host),
2. apps.common.model_logits_for_dataset(apps.jdc.config()) with the model
   loaded once in set-up (a clip's 31-frame chunks in batches of 64,
   BatchNorm on its running averages; the re-referenced pitch logits,
   [T, 721]),
3. DecoderSetup.decode_batch (the observation model, K1 -> K2 at 722
   states),

voiced flags and bins out. The loop, the pool, the window and the check
are drivers/transcribe.py's (this driver is that one with JDC's model,
front end and reference): the same lengths in the same order for every
seed, set-up transcribing the whole pool once, and after the window the
reference (perfbench/reference/stft.py, jdc.py, decode.py) transcribing the
longest served clip and others drawn from the seed. Numbers compared:
`logit_gap`, the largest difference of a logit over the reference's
largest magnitude (worst clip), and `path_gap`, how far the program's path
scores below the reference's best under the reference's own observations
(nats a frame, worst clip).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import hmm_params, traffic as T
from ..reference import jdc as ref_jdc, stft as ref_stft
from ..reference.decode import shaun_log_obs, viterbi
from ..reference.precision import matmul_precision
from ..work import model_flops
from . import View
from .transcribe import Driver as TranscribeDriver


def jdc_flops_per_frame(classes: int, chunk: int, bins: int) -> float:
    """JDC's forward FLOPs a frame: torch's FLOP counter over the reference
    on the meta device, one chunk: its convolutions, dense layers and the
    LSTMs' matrix products (written out there, so counted; the gates'
    elementwise work is not)."""
    with torch.device("meta"):
        model = ref_jdc.JDC(classes)
        example = torch.empty(1, chunk, bins)
    return model_flops(model.eval(), example) / chunk


class Driver(TranscribeDriver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        m = config["model"]
        self.classes, self.chunk, self.bins = (int(m["classes"]), int(m["chunk_frames"]),
                                               int(m["stft_bins"]))
        self._flops = self._ref = None

    def setup(self):
        from viterbi_spl_tpu_torch.apps import common, jdc as jdc_app
        from viterbi_spl_tpu_torch.cli import transcribe
        from viterbi_spl_tpu_torch.families import family_spec
        from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup

        self.common, self.transcribe = common, transcribe
        self.cfg = jdc_app.config()
        if (self.cfg.snippet_len, self.cfg.batch_size) != (self.chunk,
                                                           int(self.config["model"]["batch"])):
            raise ValueError(f"apps.jdc runs chunks of {self.cfg.snippet_len} in batches of "
                             f"{self.cfg.batch_size}; the configuration states {self.config['model']}")
        with torch.device("meta"):
            model = self.cfg.make_model(dtype=self.cfg.compute_dtype, n_pitch_classes=self.classes)
        self.model = model.to_empty(device=self.device)
        self.weights = ref_jdc.jdc_weights(self.seed, self.device)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.eval()

        h, spec = self.hmm, family_spec("jdc")
        n_bins = int(h["n_bins"])
        self.A, self.pi = hmm_params.shaped_hmm(n_bins, int(h["d_max"]), int(h["floor"]),
                                                h["switch"], self.seed)
        self.threshold = float(self.traffic["voicing_threshold"])
        self.setup_ = DecoderSetup(
            transition_matrix=self.A, init_probs=self.pi, n_bins=n_bins, note_min=spec.note_min,
            bins_per_semitone=spec.bins_per_semitone, spw=int(h["spw"]),
            voicing_threshold=self.threshold, hop_seconds=self.hop / self.sr, method=h["method"],
            obs_p=float(h["obs_p"]), obs_scale=float(h["obs_scale"]), device=self.device)

        self.frames = [int(f) for f in T.track_lengths(self.traffic["lengths"],
                                                        int(self.traffic["pool_tracks"]))]
        self.audio = [T.melody_audio(f * self.hop / self.sr, self.sr, T.sub_seed(self.seed, 7, i),
                                     self.device) for i, f in enumerate(self.frames)]
        for samples in self.audio:
            self._request(samples, None)

    def _request(self, samples, rec):
        span = rec.span if rec is not None else (lambda name: contextlib.nullcontext())
        with span("front_end"):
            feat = self.transcribe.features_from_samples("jdc", samples, device=self.device)
        with span("model"):
            logits = self.common.model_logits_for_dataset(
                self.cfg, self.model, self.transcribe._WavDataset(["clip"], [feat]))[0]
        with span("decode"):
            voiced, bins = self.setup_.decode_batch([logits])[0]
        return logits, voiced, bins

    def layer_view(self, rec) -> View:
        if self._flops is None:
            self._flops = jdc_flops_per_frame(self.classes, self.chunk, self.bins)
        extra = {"flops_per_frame": self._flops, "frames": sum(r["frames"] for r in self.records)}
        return View(rec, self.config, self.traffic, self.records, extra)

    def _reference(self, samples, precision):
        """(logits [T, 721], log observations, path [T]) of the reference at
        `precision`: the control takes the STFT in float32, the convolutions
        and the LSTMs' matrix products in TF32, the observation model in
        bfloat16."""
        feat = ref_stft.jdc_spectrogram(samples, self.device, precision)
        Tn = feat.shape[0]
        n = -(-Tn // self.chunk)
        chunks = torch.zeros((n * self.chunk, feat.shape[1]), device=self.device)
        chunks[:Tn] = feat
        if self._ref is None:
            with torch.device("meta"):
                model = ref_jdc.JDC(self.classes)
            self._ref = model.to_empty(device=self.device).eval()
            self._ref.load_state_dict(self.weights, strict=True)
        with torch.no_grad(), matmul_precision(precision):
            logits = ref_jdc.pitch_logits(self._ref(chunks.view(n, self.chunk, -1)))
        logits = logits.reshape(-1, logits.shape[-1])[:Tn]
        h = self.hmm
        th = float(np.log(self.threshold / (1 - self.threshold)))
        log_obs = shaun_log_obs(logits, th, int(h["spw"]), float(h["obs_p"]),
                                float(h["obs_scale"]), precision)
        log_B, log_pi = self._tables()
        return logits, log_obs, viterbi(log_B, log_pi, [log_obs])[0]
