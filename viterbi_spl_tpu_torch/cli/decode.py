"""Batch melody decoding service: posteriorgram files in, melody lines out
(counterpart of viterbi_spl_tpu/cli/decode.py).

Loads per-track pitch logits from files, runs the observation model and
the batched Viterbi decode on the GPU (the banded CUDA kernels when the
transition structure allows, the dense ones otherwise), and writes each
track's melody as either

- MIREX-style two-column text (time_sec  freq_hz, 0 = unvoiced), or
- an .npz with voiced/bins/est_notes/freqs/times.

HMM parameters are read from the reference-format .dat artifacts
(viterbi_transition_matrix.dat + viterbi_init_probs.dat).

    python -m viterbi_spl_tpu_torch.cli.decode \
        --family tonet --artifacts hmm_dir --out out_dir \
        --format txt input_dir/*.npy

It runs on CUDA; `--device cpu` runs the same dispatch with the kernels'
plain PyTorch versions. `--fused-obs` computes the observation model with
the fused kernels K5/K6 on the whole batch. `--mesh data=N` splits each
batch's tracks over N CUDA devices (N blocks of the CPU with
`--device cpu`).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..dist.mesh import make_mesh, mesh_device_list, parse_mesh_spec
from ..families import family_spec
from ..harness.evaluate import ALLOWED_VITERBI_METHODS, DecoderSetup
from ..io import load_array
from ..metrics.mel_eval import est_notes_with_voicing_to_hz
from ..metrics.melody import est_notes_interp


def load_logits(path: Path, transposed: bool) -> np.ndarray:
    """Load [T, n_bins] pitch logits from .dat / .npy / .npz('logits')."""
    if path.suffix == ".dat":
        arr = load_array(path)[1]
    elif path.suffix == ".npz":
        arr = np.load(path)["logits"]
    else:
        arr = np.load(path)
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected 2-D logits, got shape {arr.shape}")
    return arr.T if transposed else arr


def parse_mesh(mesh_arg: str | None, device=None):
    """--mesh data=N -> a 1-axis device mesh (None when unset): N CUDA
    devices (an error when there are fewer), or N blocks of the CPU when
    the device is the CPU."""
    if not mesh_arg:
        return None
    n_data = parse_mesh_spec(mesh_arg, axes=("data",))["data"]
    return make_mesh(data=n_data, devices=mesh_device_list(n_data, device,
                                                          f"--mesh data={n_data}"))


def build_setup(args) -> DecoderSetup:
    spec = family_spec(args.family)
    art = Path(args.artifacts)
    A = load_array(art / "viterbi_transition_matrix.dat")[1]
    pi = load_array(art / "viterbi_init_probs.dat")[1]
    if A.shape != (spec.n_bins + 1, spec.n_bins + 1):
        raise ValueError(
            f"transition matrix {A.shape} does not match family "
            f"{spec.name} ({spec.n_bins + 1} states)"
        )
    # the family carries the threshold domain: imm thresholds are
    # log-energies (imm/thresholding.py:80), everything else probabilities
    threshold = args.threshold
    if threshold is None:
        threshold = spec.voicing_threshold
    elif not spec.threshold_is_logit and not (0.0 < threshold < 1.0):
        raise ValueError(
            f"--threshold {threshold} must be a probability in (0, 1) for "
            f"family {spec.name}"
        )
    return DecoderSetup(
        transition_matrix=A,
        init_probs=pi,
        n_bins=spec.n_bins,
        note_min=spec.note_min,
        bins_per_semitone=spec.bins_per_semitone,
        spw=spec.spw,
        voicing_threshold=threshold,
        hop_seconds=spec.hop_seconds,
        method=args.method,
        threshold_is_logit=spec.threshold_is_logit,
        interp_est_notes=spec.interp_est_notes,
        fused_obs=getattr(args, "fused_obs", False),
        device=getattr(args, "device", None),
        mesh=parse_mesh(getattr(args, "mesh", None), getattr(args, "device", None)),
    )


def decode_named_logits(
    setup: DecoderSetup, names, logits_list, args, write=True
) -> list[dict]:
    """Batched decode of in-memory [T, n_bins] logits -> melody records
    (and txt/npz files when `write`)."""
    out_dir = Path(args.out)
    if write:
        out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for i in range(0, len(names), args.batch):
        group = list(names[i : i + args.batch])
        group_logits = list(logits_list[i : i + args.batch])
        decoded = setup.decode_batch(group_logits)
        for name, logits, (voiced, bins) in zip(group, group_logits, decoded):
            if setup.interp_est_notes:
                probs = torch.sigmoid(
                    torch.as_tensor(np.asarray(logits), dtype=torch.float32).to(setup.device)
                )
                est_notes = est_notes_interp(
                    bins.astype(np.int32), probs, setup.note_min,
                    setup.bins_per_semitone, setup.n_bins,
                ).cpu().numpy()
            else:
                # jdc convention: direct bin -> note grid mapping
                # (jdc/viterbi_softmax.py:2443-2470)
                grid = setup.note_min + np.arange(setup.n_bins) / setup.bins_per_semitone
                est_notes = grid[np.minimum(bins, setup.n_bins - 1)].astype(
                    np.float32
                )
            signed = np.where(voiced, est_notes, -est_notes)
            freqs = est_notes_with_voicing_to_hz(signed, min_note=setup.note_min)
            times = np.arange(len(freqs)) * setup.hop_seconds
            rec = dict(
                name=name, voiced=voiced, bins=bins,
                est_notes=est_notes, freqs=freqs, times=times,
            )
            results.append(rec)
            if not write:
                continue
            if args.format == "txt":
                outp = out_dir / (name + ".txt")
                with open(outp, "w") as fh:
                    for t, f in zip(times, np.maximum(freqs, 0.0)):
                        fh.write(f"{t:.6f}\t{f:.6f}\n")
            else:
                np.savez(
                    out_dir / (name + ".npz"),
                    voiced=voiced, bins=bins, est_notes=est_notes,
                    freqs=freqs, times=times,
                )
    return results


def decode_files(setup: DecoderSetup, paths, args, write=True) -> list[dict]:
    names = [p.stem for p in paths]
    logits_list = [load_logits(p, args.transposed) for p in paths]
    return decode_named_logits(setup, names, logits_list, args, write=write)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Batch Viterbi melody decoding (posteriorgrams -> melody)"
    )
    ap.add_argument("inputs", nargs="+", help="logit files (.npy/.npz/.dat)")
    ap.add_argument("--family", required=True)
    ap.add_argument("--artifacts", required=True,
                    help="dir with viterbi_transition_matrix.dat + "
                         "viterbi_init_probs.dat")
    ap.add_argument("--out", required=True)
    ap.add_argument("--method", default="shaun",
                    choices=list(ALLOWED_VITERBI_METHODS))
    ap.add_argument("--threshold", type=float, default=None,
                    help="voicing threshold; defaults to the family's "
                         "validated value (probability, or log-energy for "
                         "imm)")
    ap.add_argument("--batch", type=int, default=64,
                    help="tracks decoded together per kernel launch")
    ap.add_argument("--format", default="txt", choices=["txt", "npz"])
    ap.add_argument("--transposed", action="store_true",
                    help="inputs are [n_bins, T] instead of [T, n_bins]")
    ap.add_argument("--fused-obs", action="store_true",
                    help="serving fast path: the fused observation kernel "
                         "(K5/K6) on the whole batch, feeding the decoder "
                         "directly (all methods; see hmm/obs_fused.py for "
                         "the tolerance contract)")
    ap.add_argument("--mesh", default=None,
                    help="split the decode batch's tracks over a device "
                         "mesh, e.g. data=8 (N CUDA devices; with --device "
                         "cpu, N blocks of the CPU); paths identical to one "
                         "device")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip inputs whose output file already exists — "
                         "makes interrupted batch jobs restartable "
                         "(idempotent resume)")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.inputs]
    missing = [p for p in paths if not p.exists()]
    if missing:
        sys.exit(f"missing input files: {missing}")
    if args.skip_existing:
        ext = ".txt" if args.format == "txt" else ".npz"
        done = [p for p in paths if (Path(args.out) / (p.stem + ext)).exists()]
        paths = [p for p in paths if p not in done]
        if done:
            print(f"skipping {len(done)} already-decoded tracks")
    setup = build_setup(args)
    results = decode_files(setup, paths, args)
    voiced_frames = sum(int(r["voiced"].sum()) for r in results)
    total = sum(len(r["voiced"]) for r in results)
    print(
        f"decoded {len(results)} tracks, {total} frames "
        f"({voiced_frames} voiced) -> {args.out}"
    )
    return results


if __name__ == "__main__":
    main()
