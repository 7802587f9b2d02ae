"""End-to-end transcription: wav files in, melody lines out (counterpart of
viterbi_spl_tpu/cli/transcribe.py).

The top of the serving stack. `cli/decode.py` starts from saved
posteriorgram files; this entry point owns the whole chain for one or more
wav files:

    wav -> family front-end (NSGT / CFP / STFT) on the GPU
        -> acoustic model restored from the port's checkpoint file
        -> observation model + batched Viterbi decode (the CUDA kernels)
        -> MIREX melody lines (or .npz decode vectors)

For the `imm` family the chain is checkpoint-free: sinebell STFT -> IMM
NMF fit (the patience loop on the device) -> log-energy pitch logits,
matching the reference's per-recording pipeline
(imm/main_imm.py:1139-1180); `--separate` adds the stereo NMF pass and the
Wiener resynthesis.

    python -m viterbi_spl_tpu_torch.cli.transcribe song.wav \
        --family tonet --ckpt tonet.pt --artifacts hmm_dir --out melodies/
    python -m viterbi_spl_tpu_torch.cli.transcribe song.wav --family imm \
        --out melodies/ [--separate]

The checkpoint is the port's own file (harness/train.py);
scripts/orbax_to_torch.py writes one from a JAX package checkpoint. The
voicing threshold defaults to the checkpoint's validated value (imm: the
family's log-energy threshold); --threshold overrides it. It runs on CUDA;
`--device cpu` runs the same chain with the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..harness.evaluate import ALLOWED_VITERBI_METHODS
from ..utils import resolve_device
from .decode import build_setup as decode_build_setup
from .decode import decode_named_logits

# wav sample rate each family's front-end expects (the apps' builders)
FAMILY_SR = {
    "dcnet": 44100,  # NSGT on 44.1 kHz (dcnet/nsgt.py)
    "msnet": 44100,  # CFP msnet config (msnet/hsieh_m2m3.py)
    "ftanet": 8000,
    "jdc": 8000,
    "tonet": 8000,
}


def features_from_samples(family: str, samples: np.ndarray, device=None) -> np.ndarray:
    """samples (float32, at FAMILY_SR[family]) -> the family's model input,
    computed on `device` (CUDA by default). One-to-one with the apps'
    real-data spec_fns, so a transcribed wav sees the training feature
    chain. A `front_end` span (tracing.py)."""
    with tracing.span("front_end"):
        if family == "dcnet":
            from ..frontend.nsgt import dcnet_feature, nsgt_for_length

            nsgt = nsgt_for_length(len(samples), device=device)
            return dcnet_feature(nsgt.transform_track(samples))
        if family in ("msnet", "ftanet", "tonet"):
            from ..frontend import CFP, FTANET_CFP, MSNET_CFP, TONET_CFP

            cfp_cfg = {"msnet": MSNET_CFP, "ftanet": FTANET_CFP, "tonet": TONET_CFP}[family]
            with tracing.span("front_end.setup"):
                cfp = CFP(cfp_cfg, device=device)
            feat = cfp.features(samples)
            if family == "tonet":
                # tonet models take [T, 3, 360] (tonet/main_shaun.py layout)
                feat = np.ascontiguousarray(feat.transpose(0, 2, 1))
            return feat
        if family == "jdc":
            from ..frontend import jdc_spectrogram

            return jdc_spectrogram(samples, device=device)
    raise ValueError(f"unknown family {family!r}")


class _WavDataset:
    """Minimal dataset view over in-memory features (no labels:
    transcription has none), enough for model_logits_for_dataset."""

    def __init__(self, names, specs):
        from ..data.registry import Track

        empty = np.zeros(0, np.float32)
        self.track_ids = tuple(names)
        self.tracks = [
            Track(track_id=n, spectrogram=np.asarray(s, np.float32),
                  notes=np.zeros(len(s), np.float32), original_times=empty,
                  original_freqs=empty)
            for n, s in zip(names, specs)
        ]

    def __len__(self):
        return len(self.tracks)

    def __getitem__(self, idx):
        return self.tracks[idx]


def nn_logits_from_wavs(family: str, paths, ckpt: str, bf16: bool = False, device=None,
                        stages: dict | None = None):
    """wav paths -> (per-track [T, n_bins] logits, restored TrainState).
    `stages` (when given) receives the seconds of each stage: wav load,
    front-end, model load (the checkpoint read and put on the device) and
    model (the forward), each a `transcribe.<stage>` span's."""
    from ..apps.common import load_state, model_logits_for_dataset
    from ..harness.train import restore_checkpoint
    from ..io.wav import load_wav

    dev = resolve_device(device)
    cfg = importlib.import_module(f"viterbi_spl_tpu_torch.apps.{family}").config()
    if bf16:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    stages = {} if stages is None else stages

    with tracing.timed("transcribe.wav_load") as wav_load:
        samples = [load_wav(p, sr=FAMILY_SR[family])[0] for p in paths]
    with tracing.timed("transcribe.front_end") as front_end:
        specs = [features_from_samples(family, s, device=dev) for s in samples]
    with tracing.timed("transcribe.model_load") as model_load:
        state, ck_family, model_kwargs = restore_checkpoint(ckpt)
        if ck_family != family:
            raise ValueError(f"{ckpt} holds a {ck_family} model, not {family}")
        # built without drawing params (the checkpoint overwrites them all)
        with torch.device("meta"):
            model = cfg.make_model(dtype=cfg.compute_dtype, **model_kwargs)
        model = model.to_empty(device=dev).eval()
        load_state(model, state)
    with tracing.timed("transcribe.model") as forward:
        logits = model_logits_for_dataset(cfg, model, _WavDataset([p.stem for p in paths], specs))
    stages.update(wav_load=wav_load.seconds, front_end=front_end.seconds,
                  model_load=model_load.seconds, model=forward.seconds)
    return logits, state


def _imm(args):
    from ..apps.imm import debug_imm_config
    from ..models.imm import IMM, IMMConfig

    return IMM(debug_imm_config() if args.debug else IMMConfig(), device=args.device)


def _imm_setup(imm, args):
    """imm's DecoderSetup (the analytic matrix: no labels to count) with the
    CLI's overrides."""
    from ..apps.imm import build_setup as imm_build_setup

    setup = imm_build_setup(imm, method=args.method)
    overrides = {}
    if args.threshold is not None:
        overrides["voicing_threshold"] = args.threshold
    if args.fused_obs:
        overrides["fused_obs"] = True
    if args.mesh:
        from .decode import parse_mesh

        overrides["mesh"] = parse_mesh(args.mesh, args.device)
    return dataclasses.replace(setup, **overrides) if overrides else setup


def imm_logits_from_wavs(paths, imm, stages: dict | None = None):
    """wav paths -> per-track [T, U] log-energy logits. Checkpoint-free: the
    NMF is fitted per recording at inference, as in the reference
    (imm/main_imm.py:1139-1180). `stages` (when given) receives the seconds
    of each stage (wav load, STFT, NMF fit, energies), each a
    `transcribe.<stage>` span's, and the sweeps of each fit."""
    from ..io.wav import load_wav
    from ..models.adapters import imm_pitch_logits

    stages = {} if stages is None else stages
    with tracing.timed("transcribe.wav_load") as wav_load:
        samples = [load_wav(p, sr=imm.config.fs)[0] for p in paths]
    with tracing.timed("transcribe.stft") as stft:
        specs = [imm.power_spectrogram(s) for s in samples]
        _sync(imm.device)
    with tracing.timed("transcribe.nmf_fit") as nmf_fit:
        fits = [imm.fit(SX) for SX in specs]
    with tracing.timed("transcribe.energies") as energies:
        logits = [imm_pitch_logits(imm.logits_from_fit(f, SX)) for f, SX in zip(fits, specs)]
    stages.update(wav_load=wav_load.seconds, stft=stft.seconds, nmf_fit=nmf_fit.seconds,
                  energies=energies.seconds, sweeps=[f["sweeps"] for f in fits])
    return logits


def run_imm_separation(paths, names, args, stages: dict | None = None):
    """imm --separate: per input, the stereo separation pass writes
    <out>/<name>_melody.wav + <name>_accompaniment.wav (stereo, at the imm
    sample rate) and the decoded melody line (imm/tf_imm.py:354-618).
    `stages` (when given) receives the seconds of the wav load and of the
    separation chain, each a `transcribe.<stage>` span's."""
    from ..apps.imm import separate_stereo_samples
    from ..io.wav import load_wav, save_wav

    imm = _imm(args)
    setup = _imm_setup(imm, args)
    stages = {} if stages is None else stages
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for path, name in zip(paths, names):
        with tracing.timed("transcribe.wav_load") as wav_load:
            samples, _ = load_wav(path, sr=imm.config.fs, mono=False)
        with tracing.timed("transcribe.separate") as separate:
            if samples.ndim == 1:
                print(f"{name}: mono input, separating with identical channels")
                left = right = samples
            else:
                left, right = samples[:, 0], samples[:, 1]
            r = separate_stereo_samples(imm, left, right, setup)
        stages["wav_load"] = stages.get("wav_load", 0.0) + wav_load.seconds
        stages["separate"] = stages.get("separate", 0.0) + separate.seconds
        save_wav(out_dir / f"{name}_melody.wav", r["melody"], imm.config.fs)
        save_wav(out_dir / f"{name}_accompaniment.wav", r["accompaniment"], imm.config.fs)
        # the melody line alongside (times + Hz, unvoiced = 0)
        T = len(r["states"])
        times = np.arange(T) * imm.config.h / imm.config.fs
        f0s = imm.melody_f0s(r["states"], r["voiced"])
        np.savetxt(out_dir / f"{name}_melody.txt", np.stack([times, f0s], axis=1), fmt="%.6f")
        print(f"{name}: separated -> {out_dir} (NMF sweeps {r['sweeps']})")
        results.append(r)
    return results


def _sync(device) -> None:
    """Wait for the device's queued work, so that a stage's seconds are its own."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, stages: dict | None = None):
    """The CLI. `stages` (when given) receives the seconds of each stage:
    wav load, front-end, model load, model (imm: STFT, NMF fit with its
    sweeps, energies; --separate: the separation chain), and observation +
    decode. One invocation is one request of the program's spans
    (tracing.request)."""
    with tracing.request():
        return _main(argv, stages)


def _main(argv, stages: dict | None):
    ap = argparse.ArgumentParser(
        description="End-to-end melody transcription (wav -> melody lines)"
    )
    ap.add_argument("inputs", nargs="+", help="wav files")
    ap.add_argument("--family", required=True, choices=sorted(FAMILY_SR) + ["imm"])
    ap.add_argument("--ckpt", default=None,
                    help="the port's checkpoint file (scripts/orbax_to_torch.py "
                         "makes one from a JAX package checkpoint; the NN "
                         "families only: imm fits its NMF per recording)")
    ap.add_argument("--artifacts", default=None,
                    help="dir with viterbi_transition_matrix.dat + "
                         "viterbi_init_probs.dat (NN families; imm builds "
                         "its analytic transition)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--method", default="shaun",
                    choices=list(ALLOWED_VITERBI_METHODS))
    ap.add_argument("--threshold", type=float, default=None,
                    help="voicing threshold; defaults to the checkpoint's "
                         "validated value (or the family default for imm)")
    ap.add_argument("--batch", type=int, default=16,
                    help="tracks decoded together per kernel launch")
    ap.add_argument("--format", default="txt", choices=["txt", "npz"])
    ap.add_argument("--fused-obs", action="store_true",
                    help="fused observation kernel serving path (K5/K6)")
    ap.add_argument("--mesh", default=None,
                    help="split the decode batch over a device mesh, e.g. data=8")
    ap.add_argument("--bf16", action="store_true",
                    help="run the model's convs/denses/LSTMs in bfloat16")
    ap.add_argument("--debug", action="store_true",
                    help="imm only: tiny NMF configuration (fast smoke)")
    ap.add_argument("--separate", action="store_true",
                    help="imm only: stereo source separation: the second "
                         "melody-constrained NMF pass with per-channel "
                         "gains + Wiener-mask resynthesis writes "
                         "<name>_melody.wav and <name>_accompaniment.wav "
                         "next to the melody lines (imm/tf_imm.py:354-618)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.inputs]
    missing = [p for p in paths if not p.exists()]
    if missing:
        sys.exit(f"missing input files: {missing}")
    names = [p.stem for p in paths]

    if args.separate and args.family != "imm":
        sys.exit("--separate is the imm stereo separation pass")
    stages = {} if stages is None else stages
    if args.separate:
        return run_imm_separation(paths, names, args, stages=stages)

    if args.family == "imm":
        imm = _imm(args)
        logits_list = imm_logits_from_wavs(paths, imm, stages=stages)
        setup = _imm_setup(imm, args)
    else:
        if args.ckpt is None:
            sys.exit(f"--ckpt is required for family {args.family}")
        if args.artifacts is None:
            sys.exit(f"--artifacts is required for family {args.family}")
        logits_list, state = nn_logits_from_wavs(
            args.family, paths, args.ckpt, bf16=args.bf16, device=args.device, stages=stages
        )
        threshold = args.threshold if args.threshold is not None else float(state.voicing_threshold)
        setup = decode_build_setup(
            argparse.Namespace(
                family=args.family, artifacts=args.artifacts, threshold=threshold,
                method=args.method, mesh=args.mesh, fused_obs=args.fused_obs,
                device=args.device,
            )
        )
    with tracing.timed("transcribe.decode") as decode:
        results = decode_named_logits(setup, names, logits_list, args)
    stages["decode"] = decode.seconds
    voiced_frames = sum(int(r["voiced"].sum()) for r in results)
    total = sum(len(r["voiced"]) for r in results)
    print(
        f"transcribed {len(results)} tracks, {total} frames "
        f"({voiced_frames} voiced) -> {args.out}; seconds: "
        + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in stages.items())
    )
    return results


if __name__ == "__main__":
    main()
