"""Smoke run of the PyTorch/CUDA port on one GPU: builds the decode kernels
from csrc/, holds each against its plain PyTorch version and the NumPy
oracle, drives the decode service end to end through its entry points, and
times the kernels at full width.

    python3 chip_smoke.py

Phases (one JSON line each):
  1. device: nvidia-smi name and power limit, torch/CUDA versions, build time.
  2. kernels against their plain versions on the card (N=16, T<=1024,
     ragged lengths): K1/K2 at 361 states (tonet, d_max 14) and 722 (jdc,
     d_max 40), K3/K4 at 722 (imm's analytic matrix) and 361 (a random
     dense matrix); exact equality (tolerance 0), and track 0 against the
     oracle.
  3. the main path: tonet artifacts from synthetic note tracks, 8 logit
     files, the decode CLI on its default device for all three methods
     (K1/K2 must launch), then a DecoderSetup with imm's analytic matrix
     (K3/K4 must launch); track 0 against the oracle each time. After the
     launch counts are read, each kernel against its plain version again,
     exactly, on the log observations of those two batches.
  4. timed decode at full width: N=128 x T=32768 at 361 states (banded),
     N=64 x T=4096 at 722 (banded), N=16 x T=4096 at 361 and 722 (dense).
  5. the kernels line: per kernel its launches on the main path, equality
     error, time, plain-version time, bound and what bounds it.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero and prints no result; it also exits non-zero
without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import viterbi_spl_tpu_torch
from viterbi_spl_tpu_torch import cuda_lib
from viterbi_spl_tpu_torch.cli import decode as cli_decode
from viterbi_spl_tpu_torch.cli.hmm_artifacts import (
    build_hmm_artifacts,
    quantize_tracks_for_family,
)
from viterbi_spl_tpu_torch.families import family_spec
from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup
from viterbi_spl_tpu_torch.hmm import params as hmm_params
from viterbi_spl_tpu_torch.hmm import viterbi_banded as VB
from viterbi_spl_tpu_torch.hmm import viterbi_dense as VD
from viterbi_spl_tpu_torch.hmm.oracle import viterbi_oracle_log
from viterbi_spl_tpu_torch.hmm.viterbi import log_obs_fn, prepare_log_params

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 outside the
# tensor cores (max-plus DP has no tensor-core form)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
METHODS = ("shaun", "softmax-scaled", "softmax-unscaled")
KERNEL_INFO = {
    "K1": ("banded_forward", "viterbi_spl_tpu_torch/csrc/viterbi_banded.cu",
           "viterbi_spl_tpu/hmm/viterbi_banded.py:467"),
    "K2": ("banded_backtrace", "viterbi_spl_tpu_torch/csrc/viterbi_banded.cu",
           "viterbi_spl_tpu/hmm/viterbi_banded.py:773"),
    "K3": ("dense_forward", "viterbi_spl_tpu_torch/csrc/viterbi_dense.cu",
           "viterbi_spl_tpu/hmm/viterbi_pallas.py:507"),
    "K4": ("dense_backtrace", "viterbi_spl_tpu_torch/csrc/viterbi_dense.cu",
           "viterbi_spl_tpu/hmm/viterbi_pallas.py:558"),
}


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def shaped_matrix(n_bins: int, d_max: int, seed: int):
    """A shaped (banded + switch-coupled) melody HMM from a synthetic pitch
    walk, through the port's parameter pipeline (bench.py's construction)."""
    rng = np.random.default_rng(seed)
    walk = [np.clip(n_bins // 2 + np.cumsum(rng.integers(-3, 4, 5000)), 0, n_bins - 1)]
    stats = hmm_params.count_statistics(walk, n_bins)
    A = hmm_params.shape_transition_matrix(
        stats.transition_counts, np.array([[0.98, 0.02], [0.02, 0.98]]),
        n_bins, d_max, floor=2,
    )
    return A, hmm_params.shape_init_probs(stats.p_steady, p_th=1e-4)


def dense_matrix(S: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.random((S, S)).astype(np.float32) ** 4
    A /= A.sum(axis=1, keepdims=True)
    return A, np.full(S, 1.0 / S)


def uniform_log_obs(N, T, S, seed, dev):
    """Log observations uniform in [-20, 0), made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((N, T, S), generator=g, device=dev).mul_(20.0).sub_(20.0)


def cuda_ms(fn, iters: int) -> float:
    """Median ms of fn() over iters back-to-back launches after one warm-up:
    a CUDA event between consecutive launches times each one, so a one-off
    stall (an allocation, a neighbour on the host) moves no reading."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))


def kernel_pair(kind, A, pi, log_obs, lengths):
    """(forward, backtrace) closures of the banded or dense kernels for
    one matrix, and the matching plain versions."""
    log_B, log_pi = prepare_log_params(A, pi)
    if kind == "banded":
        bs = VB.extract_banded_structure(A)
        check(bs is not None, "shaped matrix has the banded structure")
        fwd = lambda o, L: VB.banded_forward(bs, log_pi, o, L)  # noqa: E731
        bt = lambda t1m1, last, L: VB.banded_backtrace(bs, t1m1, last, L)  # noqa: E731
        fwd_p = lambda o, L: VB.banded_forward_plain(bs, torch.from_numpy(log_pi).to(o.device), o, L)  # noqa: E731
        bt_p = lambda t1m1, last, L: VB.banded_backtrace_plain(bs, t1m1, last, L)  # noqa: E731
    else:
        check(VB.extract_banded_structure(A) is None, "dense matrix has no banded structure")
        dev = log_obs.device
        lB, lpi = torch.from_numpy(log_B).to(dev), torch.from_numpy(log_pi).to(dev)
        fwd = lambda o, L: VD.dense_forward(log_B, log_pi, o, L)  # noqa: E731
        bt = lambda t1m1, last, L: VD.dense_backtrace(log_B, t1m1, last, L)  # noqa: E731
        fwd_p = lambda o, L: VD.dense_forward_plain(lB, lpi, o, L)  # noqa: E731
        bt_p = lambda t1m1, last, L: VD.dense_backtrace_plain(lB, t1m1, last, L)  # noqa: E731
    return (fwd, bt, fwd_p, bt_p), log_B, log_pi


def compare_kernels(kind, A, pi, log_obs, lengths):
    """One matrix's forward and backtrace kernels against their plain
    versions on the same inputs: (forward error, backtrace error, track 0
    equals the oracle). The errors are the largest absolute differences of
    t1_last, of t1m1 up to each track's length and of the states."""
    (fwd, bt, fwd_p, bt_p), log_B, log_pi = kernel_pair(kind, A, pi, log_obs, lengths)
    t1_k, t1m1_k = fwd(log_obs, lengths)
    t1_p, t1m1_p = fwd_p(log_obs, lengths)
    last = torch.argmax(t1_p, dim=1).to(torch.int32)
    st_k = bt(t1m1_k, last, lengths)
    st_p = bt_p(t1m1_p, last, lengths)
    torch.cuda.synchronize()
    f_err = float((t1_k - t1_p).abs().max())
    b_err = 0.0
    for n, L in enumerate(lengths):
        L = int(L)
        f_err = max(f_err, float((t1m1_k[n, :L] - t1m1_p[n, :L]).abs().max()))
        b_err = max(b_err, float((st_k[n, :L] - st_p[n, :L]).abs().max()))
    L0 = int(lengths[0])
    oracle = viterbi_oracle_log(log_B, log_pi, log_obs[0, :L0].cpu().numpy())
    return f_err, b_err, bool(np.array_equal(st_k[0, :L0].cpu().numpy(), oracle))


def record_errors(errs, kind, label, N, T, f_err, b_err, oracle_ok) -> None:
    """Emit one equality line, fold it into errs, and fail unless exact."""
    kf, kb = ("K1", "K2") if kind == "banded" else ("K3", "K4")
    errs[kf] = max(errs[kf], f_err)
    errs[kb] = max(errs[kb], b_err)
    emit({"phase": "equality", "kind": kind, "shape": label, "N": N, "T": T,
          "forward_max_abs_err": f_err, "backtrace_max_abs_err": b_err,
          "track0_matches_oracle": oracle_ok})
    check(f_err == 0.0 and b_err == 0.0, f"{kind} {label}: kernels equal their plain versions")
    check(oracle_ok, f"{kind} {label}: track 0 equals the oracle")


def phase_equality(dev, errs) -> None:
    """Kernels against plain versions and the oracle at N=16, T=1024 with
    ragged lengths; folds the largest absolute difference per kernel id
    into errs."""
    rng = np.random.default_rng(1)
    cases = [
        ("banded", 361, shaped_matrix(360, hmm_params.single_side_d_max(0.01, 60), 0)),
        ("banded", 722, shaped_matrix(721, 40, 1)),
        ("dense", 722, (hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))),
        ("dense", 361, dense_matrix(361, 2)),
    ]
    N, T = 16, 1024
    for kind, S, (A, pi) in cases:
        lengths = rng.integers(T // 4, T + 1, N).astype(np.int32)
        lengths[0], lengths[1] = T, 1
        log_obs = uniform_log_obs(N, T, S, seed=S, dev=dev)
        record_errors(errs, kind, str(S), N, T, *compare_kernels(kind, A, pi, log_obs, lengths))


def padded_log_obs(setup, logits_list):
    """The [N, T_max, S] log observations and the lengths that
    DecoderSetup.decode_batch hands the kernels for these tracks."""
    obs = [setup.observation_probs(lg) for lg in logits_list]
    lengths = np.array([o.shape[0] for o in obs], np.int32)
    batch = torch.zeros((len(obs), int(lengths.max()), obs[0].shape[1]), device=setup.device)
    for i, o in enumerate(obs):
        batch[i, : lengths[i]] = o
    return log_obs_fn(batch), lengths


def phase_main_path(dev, errs) -> dict:
    """The decode service through its entry points; returns the launches
    of each kernel in this run. Then holds each kernel against its plain
    version at the shapes the main path gave it, folding the errors into
    errs."""
    rng = np.random.default_rng(3)
    for wrapper in VD.KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    spec = family_spec("tonet")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # synthetic note tracks (MIDI, 0 = unvoiced) -> quantized -> artifacts
        notes = []
        for _ in range(4):
            walk = 60.0 + np.cumsum(rng.integers(-2, 3, 4000)) / 5.0
            voiced = np.repeat(rng.random(200) > 0.25, 20)
            notes.append(np.where(voiced, np.clip(walk, 40.0, 90.0), 0.0))
        build_hmm_artifacts(quantize_tracks_for_family(notes, spec), spec, tmp / "hmm")
        paths = []
        for i, T in enumerate(np.linspace(2000, 8000, 8).astype(int)):
            logits = rng.normal(-2.0, 1.0, (T, spec.n_bins)).astype(np.float32)
            line = np.clip(180 + np.cumsum(rng.integers(-1, 2, T)), 0, spec.n_bins - 1)
            logits[np.arange(T), line] += 6.0
            paths.append(tmp / f"track{i}.npy")
            np.save(paths[-1], logits)
        frames = 0
        t0 = time.perf_counter()
        for method in METHODS:
            out = tmp / method
            recs = cli_decode.main(
                [str(p) for p in paths]
                + ["--family", "tonet", "--artifacts", str(tmp / "hmm"),
                   "--out", str(out), "--method", method, "--format", "txt"]
            )
            for p, rec in zip(paths, recs):
                n_lines = len((out / f"{p.stem}.txt").read_text().splitlines())
                check(n_lines == len(rec["voiced"]) == np.load(p).shape[0],
                      f"{method}: {p.stem}.txt has one line per frame")
                frames += n_lines
            # track 0 against the oracle on the same log observations
            setup = cli_decode.build_setup(type("Args", (), dict(
                family="tonet", artifacts=str(tmp / "hmm"), threshold=None,
                method=method))())
            check(setup.device.type == "cuda", "the CLI's default device is cuda")
            log_obs = log_obs_fn(setup.observation_probs(np.load(paths[0]))).cpu().numpy()
            log_B, log_pi = prepare_log_params(setup.transition_matrix, setup.init_probs)
            states = np.where(recs[0]["voiced"], recs[0]["bins"], spec.n_bins)
            check(np.array_equal(states, viterbi_oracle_log(log_B, log_pi, log_obs)),
                  f"{method}: CLI track 0 equals the oracle")
        cli_s = time.perf_counter() - t0
        banded = {k: VD.KERNEL_WRAPPERS[k].launches for k in ("K1", "K2")}
        check(banded["K1"] >= 3 and banded["K2"] >= 3, f"CLI ran K1/K2: {banded}")
        cli_setup, cli_logits = setup, [np.load(p) for p in paths]

    # the dense path: imm's analytic matrix through DecoderSetup
    imm = family_spec("imm")
    setup = DecoderSetup(
        transition_matrix=hmm_params.imm_transition_matrix(20, imm.n_bins),
        init_probs=np.full(imm.n_bins + 1, 1.0 / (imm.n_bins + 1)),
        n_bins=imm.n_bins, note_min=imm.note_min,
        bins_per_semitone=imm.bins_per_semitone, spw=imm.spw,
        voicing_threshold=imm.voicing_threshold, hop_seconds=imm.hop_seconds,
        threshold_is_logit=True,
    )
    logits = []
    for T in (1500, 700, 1100, 500):
        lg = rng.normal(0.0, 1.0, (T, imm.n_bins)).astype(np.float32)
        line = np.clip(360 + np.cumsum(rng.integers(-3, 4, T)), 0, imm.n_bins - 1)
        lg[np.arange(T), line] += 5.0
        logits.append(lg)
    (voiced, bins), *_ = setup.decode_batch(logits)
    log_obs = log_obs_fn(setup.observation_probs(logits[0])).cpu().numpy()
    log_B, log_pi = prepare_log_params(setup.transition_matrix, setup.init_probs)
    check(np.array_equal(np.where(voiced, bins, imm.n_bins),
                         viterbi_oracle_log(log_B, log_pi, log_obs)),
          "imm DecoderSetup track 0 equals the oracle")
    launches = {k: w.launches for k, w in VD.KERNEL_WRAPPERS.items()}
    emit({"phase": "main_path", "cli_tracks": len(paths), "cli_methods": list(METHODS),
          "cli_frames": frames, "cli_seconds": cli_s, "imm_tracks": len(logits),
          "launches": launches})
    check(all(v > 0 for v in launches.values()), f"every kernel ran on the main path: {launches}")

    # the kernels against their plain versions on the main path's inputs
    # (after the counts are read: these launches do not count)
    for kind, label, st, lgs in (("banded", "main path tonet 361", cli_setup, cli_logits),
                                 ("dense", "main path imm 722", setup, logits)):
        log_obs, lengths = padded_log_obs(st, lgs)
        record_errors(errs, kind, label, len(lengths), log_obs.shape[1], *compare_kernels(
            kind, st.transition_matrix, st.init_probs, log_obs, lengths))
    return launches


def bounds(kernel, S, lengths, bs=None):
    """(bound_ms, bound_by) from the bytes each input and output needs once
    and the FP32 operations this run's lengths need."""
    frames = int(np.sum(lengths))
    steps = int(np.sum(np.asarray(lengths) - 1))
    row = 4 * S
    if kernel in ("K1", "K3"):
        nbytes = 2 * frames * row + (S * S * 4 if kernel == "K3" else 0)
        if kernel == "K1":
            n = S - 1
            inband = sum(min(bs.d_max, n - 1 - s) - max(-bs.d_max, -s) + 1 for s in range(n))
            # in-band add+max, seed (2 adds, 1 max), obs add, the voiced max
            # reduction, and the unvoiced target's 4 operations
            ops = steps * (2 * inband + 4 * n + n + 4)
        else:
            ops = steps * 2 * S * S
    else:
        nbytes = steps * row + frames * 4 + (S * S * 4 if kernel == "K4" else 0)
        ops = steps * 2 * S  # one add and one compare per candidate
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def full_width_shapes():
    """(kind, label, N, T, (A, pi)): bench.py's headline shape, jdc's
    722-state shape, and the dense kernels at 361 and 722 states."""
    return [
        ("banded", "tonet 361", 128, 32768,
         shaped_matrix(360, hmm_params.single_side_d_max(0.01, 60), 0)),
        ("banded", "jdc 722", 64, 4096, shaped_matrix(721, 40, 1)),
        ("dense", "imm 722", 16, 4096,
         (hmm_params.imm_transition_matrix(20, 721), np.full(722, 1.0 / 722))),
        ("dense", "random 361", 16, 4096, dense_matrix(361, 2)),
    ]


def phase_timing(dev, shapes) -> dict:
    """Per shape: kernel ms, plain ms (short T, scaled per frame), bound."""
    T_PLAIN = 32
    results = {}
    for kind, label, N, T, (A, pi) in shapes:
        S = A.shape[0]
        lengths = np.full(N, T, np.int32)
        log_obs = uniform_log_obs(N, T, S, seed=7, dev=dev)
        (fwd, bt, fwd_p, bt_p), log_B, log_pi = kernel_pair(kind, A, pi, log_obs, lengths)
        kf, kb = ("K1", "K2") if kind == "banded" else ("K3", "K4")
        iters = 5 if T * N > 1 << 20 else 10
        out = {}
        ms_f = cuda_ms(lambda: out.update(f=fwd(log_obs, lengths)), iters)
        t1_last, t1m1 = out.pop("f")
        last = torch.argmax(t1_last, dim=1).to(torch.int32)
        ms_b = cuda_ms(lambda: out.update(b=bt(t1m1, last, lengths)), iters)
        states = out.pop("b")

        def decode():
            t1, rows = fwd(log_obs, lengths)
            return bt(rows, torch.argmax(t1, dim=1).to(torch.int32), lengths)

        del t1m1
        torch.cuda.empty_cache()
        ms_decode = cuda_ms(decode, iters)
        t0 = time.perf_counter()
        oracle = viterbi_oracle_log(log_B, log_pi, log_obs[0].cpu().numpy())
        oracle_s = time.perf_counter() - t0
        oracle_ok = bool(np.array_equal(states[0].cpu().numpy(), oracle))
        check(oracle_ok, f"{label}: full-width track 0 equals the oracle")

        short = log_obs[:, :T_PLAIN].contiguous()
        lens_s = np.full(N, T_PLAIN, np.int32)
        res = {}
        ms_fp = cuda_ms(lambda: res.update(f=fwd_p(short, lens_s)), 1) * T / T_PLAIN
        t1_s, rows_s = res["f"]
        last_s = torch.argmax(t1_s, dim=1).to(torch.int32)
        ms_bp = cuda_ms(lambda: bt_p(rows_s, last_s, lens_s), 1) * T / T_PLAIN

        bs = VB.extract_banded_structure(A) if kind == "banded" else None
        bf = bounds(kf, S, lengths, bs)
        bb = bounds(kb, S, lengths, bs)
        rec = {"phase": "timing", "shape": label, "N": N, "T": T, "S": S,
               "decode_ms": ms_decode, "frames_per_s": N * T / (ms_decode / 1e3),
               f"{kf}_ms": ms_f, f"{kb}_ms": ms_b,
               f"{kf}_plain_ms": ms_fp, f"{kb}_plain_ms": ms_bp,
               f"{kf}_bound_ms": bf[0], f"{kf}_bound_by": bf[1],
               f"{kb}_bound_ms": bb[0], f"{kb}_bound_by": bb[1],
               "plain_T": T_PLAIN, "oracle_seconds": oracle_s, "track0_matches_oracle": oracle_ok}
        emit(rec)
        results[label] = rec
        del log_obs, states, short, res, out
        torch.cuda.empty_cache()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    check(Path(viterbi_spl_tpu_torch.__file__).resolve().parent.parent == here,
          "the port package beside this script is the one imported")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": build_s, "ptxas": ptxas})

    errs = {k: 0.0 for k in KERNEL_INFO}
    phase_equality(dev, errs)
    launches = phase_main_path(dev, errs)
    timing = phase_timing(dev, full_width_shapes())

    headline = {"K1": "tonet 361", "K2": "tonet 361", "K3": "imm 722", "K4": "imm 722"}
    kernels = []
    for k, (name, source, replaces) in KERNEL_INFO.items():
        def entry(rec):
            return {"shape": f"{rec['shape']} N={rec['N']} T={rec['T']}",
                    "ms": rec[f"{k}_ms"], "plain_ms": rec[f"{k}_plain_ms"],
                    "bound_ms": rec[f"{k}_bound_ms"], "bound_by": rec[f"{k}_bound_by"]}
        main_rec = timing[headline[k]]
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k], "max_abs_err": errs[k],
            **entry(main_rec), "library_ms": None,
            "other_shapes": [entry(r) for lbl, r in timing.items()
                             if lbl != headline[k] and f"{k}_ms" in r],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
