"""IMM app (reference imm/main_imm.py + imm/thresholding.py; counterpart of
viterbi_spl_tpu/apps/imm.py): the NMF is fitted per recording at inference;
three evaluation methods:

- original:      HF0 log observations -> Viterbi with the analytic
                 transition + cumulative-energy voicing (imm/tf_imm.py:680-776),
- thresholding:  log-energy logits + hard energy threshold (raw path),
- viterbi:       shaun observation model (spw=20) over the log-energy
                 logits + shaped decoding (imm/thresholding.py:157-941).

The NMF, the decodes (K3/K4 on the card) and the metrics run on the device
given with --device (CUDA unless 'cpu').

Run: python -m viterbi_spl_tpu_torch.apps.imm eval --synthetic --debug
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..harness.evaluate import DecoderSetup, evaluate_posteriorgrams
from ..hmm.viterbi_dense import dense_backtrace, dense_forward
from ..metrics.mel_eval import evaluate_melody, hz_to_midi, midi_to_hz
from ..models.adapters import imm_pitch_logits
from ..models.imm import IMM, IMMConfig


def debug_imm_config() -> IMMConfig:
    """The small-NMF debug config for synthetic/smoke paths (tiny bases,
    coarse pitch grid, cheap w=512/h=64 STFT). Shared with the transcribe
    CLI so the debug NMF cannot silently diverge between entry points;
    real-data debug keeps the reference's w/h/fs (see main)."""
    return IMMConfig(w=512, h=64, niters=15, R=6, P=8, K=4, bins_per_note=4)


def synthetic_tracks(imm: IMM, n_tracks: int, seconds: float, seed: int, keep_fits: bool = False):
    """Synthetic harmonic mixtures -> per-track log-energy logits + labels.
    With keep_fits, each track dict also carries SX + the NMF fit (needed by
    the 'original' evaluation method)."""
    rng = np.random.default_rng(seed)
    tracks = []
    for _ in range(n_tracks):
        sr = imm.config.fs
        n = int(sr * seconds)
        t = np.arange(n) / sr
        f0 = 220.0 * 2 ** rng.uniform(-0.5, 0.5)
        y = sum((0.6 / k) * np.sin(2 * np.pi * f0 * k * t) for k in range(1, 6))
        y = (y + 0.02 * rng.normal(size=n)).astype(np.float32)
        if keep_fits:
            SX = imm.power_spectrogram(y)
            fit = imm.fit(SX, seed=seed)
            logits_un = imm.logits_from_fit(fit, SX)
        else:
            SX = fit = None
            logits_un = imm.logits(y, seed=seed)
        logits = imm_pitch_logits(logits_un)
        T = logits.shape[0]
        notes = np.full(T, hz_to_midi(np.array([f0]))[0], np.float32)
        rec = dict(
            logits=logits,
            notes=notes,
            original=dict(times=np.arange(T) * imm.config.h / sr, freqs=midi_to_hz(notes)),
        )
        if keep_fits:
            rec["SX"] = SX
            rec["fit"] = fit
        tracks.append(rec)
    return tracks


def build_setup(imm: IMM, method: str = "shaun", stats_notes=None) -> DecoderSetup:
    """DecoderSetup for the imm 'viterbi' evaluation method, on the IMM
    instance's device.

    stats_notes: optional list of per-track reference MIDI note arrays.
    When given, the transition matrix/init probs are the SHAPED
    data-counted ones (d_max-banded distance counts + counted
    voiced/unvoiced switch), which is what the reference's imm viterbi
    loads (`viterbi_transition_matrix.dat`, produced by
    imm/viterbi_transition_post_processing.py:36-100 with d_max =
    35.92*0.01*240*1.3//2 = 56; main_imm.py:254-270 loads it). The
    ANALYTIC exp-decay matrix (imm/transition_matrix.py) belongs only to
    the 'original' method (tf_imm's internal decode): its unvoiced state
    is unreachable by construction (P(voiced->unvoiced) ~ 1e-90), so
    using it under the shaun observation model forces an all-voiced path.
    It stays the fallback for degenerate statistics and for label-free
    serving (cli/transcribe.py), as in the JAX package."""
    from ..hmm import params as hmm_params

    note_range = hz_to_midi(imm.f0s).astype(np.float32)
    U = imm.config.U
    bps = float(imm.config.bins_per_note)
    stats = None
    if stats_notes is not None:
        q = [
            hmm_params.quantize_ref_notes(notes, float(note_range[0]), float(note_range[-1]), bps, U)
            for notes in stats_notes
        ]
        stats = hmm_params.count_statistics(q, U)
        if not np.all(stats.switch.sum(axis=1) > 0.999):
            # degenerate stats (e.g. all-voiced synthetic tracks observe
            # no unvoiced frames, so the unvoiced switch row has zero
            # counts): shaping needs both states; fall back to the
            # analytic matrix like the label-free serving path
            stats = None
    if stats is not None:
        d_max = hmm_params.single_side_d_max(0.01, int(12 * bps))
        A = hmm_params.shape_transition_matrix(
            stats.transition_counts, stats.switch, U, d_max, floor=2
        )
        pi = hmm_params.shape_init_probs(stats.p_steady)
    else:
        A = imm.transition_matrix
        pi = np.full(U + 1, 1.0 / (U + 1))
    return DecoderSetup(
        transition_matrix=A,
        init_probs=pi,
        n_bins=U,
        note_min=float(note_range[0]),
        bins_per_semitone=bps,
        spw=20 if U == 721 else max(imm.config.bins_per_note, 2),
        voicing_threshold=2.442347,  # log-energy threshold (imm/thresholding.py:80)
        hop_seconds=imm.config.h / imm.config.fs,
        method=method,
        threshold_is_logit=True,
        device=imm.device,
    )


def _medleydb_label(tid):
    from ..data.labels import medleydb_label
    from ..data.vocals import is_vocals_from_sections

    return medleydb_label(tid, is_vocals_from_sections(tid))


def _medleydb_wav(imm: IMM, tid):
    from ..io.wav import load_wav

    wav = os.path.join(os.environ["medleydb"], tid, tid + "_MIX.wav")
    return load_wav(wav, sr=imm.config.fs)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="imm app")
    ap.add_argument("mode", choices=["eval"])
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--original", action="store_true",
                    help="also run the reference's 'original' method "
                         "(HF0 + analytic transition + cumulative-energy "
                         "voicing, imm/tf_imm.py:680-776)")
    ap.add_argument("--external-eval", action="store_true",
                    help="also evaluate on adc04/mirex05/mir1k (whichever "
                         "env roots are set): the corpora the reference's "
                         "imm harness covers (imm/main_imm.py); per-track "
                         "NMF fits like the mdb path")
    ap.add_argument("--calibrate-threshold", action="store_true",
                    help="sweep the log-energy voicing threshold over the "
                         "validation split and report the best: the "
                         "in-framework producer of the reference's "
                         "2.442347 constant (imm/thresholding.py:80, "
                         "calibration class :156-347)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.synthetic:
        cfg = debug_imm_config() if args.debug else IMMConfig()
    else:
        # real data pairs the NMF logits with MedleyDB MELODY2 labels on the
        # 256-sample hop, so the debug config must keep w/h/fs at the
        # reference values (imm/main_imm.py hopsize 256) and only shrink
        # the NMF (iterations, bases, pitch grid)
        cfg = IMMConfig(niters=15, R=6, P=8, K=4, bins_per_note=4) if args.debug else IMMConfig()
    imm = IMM(cfg, device=args.device)

    if args.synthetic:
        tracks = synthetic_tracks(imm, 2 if args.debug else 6, 0.5 if args.debug else 5.0,
                                  seed=0, keep_fits=args.original)
    else:
        from ..data import medleydb_splits

        tracks = []
        test_tids = medleydb_splits()["test"]
        if args.debug:
            test_tids = test_tids[:2]
        for tid in test_tids:
            samples = _medleydb_wav(imm, tid)
            # keep SX + the NMF fit when the 'original' method is requested
            # (it decodes the raw HF0 salience; the reference runs it on
            # real corpora too, imm/original_adc04_performance.py)
            SX = imm.power_spectrogram(samples)
            fit = imm.fit(SX, seed=0)
            logits = imm_pitch_logits(imm.logits_from_fit(fit, SX))
            lb = _medleydb_label(tid)
            rec = dict(logits=logits, notes=lb["notes"][: logits.shape[0]],
                       original=lb["original"])
            if args.original:
                rec["SX"] = SX
                rec["fit"] = fit
            tracks.append(rec)

    # transition/init statistics: the reference's imm viterbi loads the
    # data-counted shaped artifacts (main_imm.py:254-270); they are counted
    # from the medleydb VALIDATION split like the other families'
    # (synthetic mode counts from the synthetic tracks' own labels: there is
    # no other split)
    if args.synthetic:
        stats_notes = [t["notes"] for t in tracks]
    else:
        from ..data import medleydb_splits

        val_tids = medleydb_splits()["validation"]
        if args.debug:
            val_tids = val_tids[:2]
        stats_notes = [_medleydb_label(tid)["notes"] for tid in val_tids]
    setup = build_setup(imm, stats_notes=stats_notes)
    out = evaluate_posteriorgrams(setup, tracks)
    print(f"thresholding OA {out['raw_mean_oa']:.4f}, viterbi OA {out['viterbi_mean_oa']:.4f}")
    if args.external_eval:
        out.update(external_eval(imm, setup, args.debug, args.original))
    if args.original:
        orig = evaluate_imm_original(imm, tracks)
        out["original"] = orig
        print(f"original OA {orig['mean_oa']:.4f}")
    if args.calibrate_threshold:
        out["calibration"] = calibrate_energy_threshold(imm, setup, args, tracks)
        best = out["calibration"]["best_threshold"]
        print(
            f"calibrated log-energy threshold {best:.6f} "
            f"(prob {1.0 / (1.0 + np.exp(-best)):.2f}); "
            f"reference constant 2.442347 = logit(0.92)"
        )
    return out


def external_eval(imm: IMM, setup: DecoderSetup, debug: bool, original: bool) -> dict:
    """The reference's imm harness on adc04/mirex05/mir1k (imm/main_imm.py;
    NOT rwc), whichever env roots are set, with per-recording NMF fits ->
    {corpus: evaluate_posteriorgrams' result, with "original" when asked}.
    The imm "feature" for build_external_eval_datasets IS the log-energy
    logits, which land on the corpora's 256-hop label grid. One call of it
    per corpus, so that each track's spectrogram and fit are kept in
    call order when the 'original' method needs them
    (imm/original_adc04_performance.py decodes the raw HF0 per track)."""
    from .common import build_external_eval_datasets

    out = {}
    for corpus in ("adc04", "mirex05", "mir1k"):
        aux: list[dict] = []

        def feature(samples, _aux=aux):
            SX = imm.power_spectrogram(samples)
            fit = imm.fit(SX, seed=0)
            if original:
                _aux.append(dict(SX=SX, fit=fit))
            return imm_pitch_logits(imm.logits_from_fit(fit, SX))

        ext = build_external_eval_datasets(feature, sr=imm.config.fs, debug=debug,
                                           corpora=(corpus,))
        if corpus not in ext:
            continue
        tracks = [
            dict(logits=np.asarray(t.spectrogram), notes=np.asarray(t.notes),
                 original=dict(times=np.asarray(t.original_times),
                               freqs=np.asarray(t.original_freqs)),
                 **(aux[i] if original else {}))
            for i, t in enumerate(ext[corpus].tracks)
        ]
        res = evaluate_posteriorgrams(setup, tracks)
        out[corpus] = res
        print(f"{corpus}: thresholding OA {res['raw_mean_oa']:.4f}, "
              f"viterbi OA {res['viterbi_mean_oa']:.4f}")
        if original:
            res["original"] = evaluate_imm_original(imm, tracks)
            print(f"{corpus}: original OA {res['original']['mean_oa']:.4f}")
    return out


def calibrate_energy_threshold(imm: IMM, setup, args, fallback_tracks):
    """Sweep the log-energy voicing threshold on the validation split: the
    in-framework derivation of the reference's 2.442347 constant
    (imm/thresholding.py:80; ValidationVoicingAccuracy :156-347 sweeps
    logit(p) for p in .01...99 against max frame log energies and picks
    argmax mean VA). Synthetic mode sweeps over the in-hand tracks."""
    from ..harness.threshold import sweep_voicing_thresholds

    if args.synthetic:
        val_tracks = fallback_tracks
    else:
        from ..data import medleydb_splits

        val_tids = medleydb_splits()["validation"]
        if args.debug:
            val_tids = val_tids[:2]
        val_tracks = []
        for tid in val_tids:
            logits = imm_pitch_logits(imm.logits(_medleydb_wav(imm, tid), seed=0))
            lb = _medleydb_label(tid)
            val_tracks.append(dict(logits=logits, notes=lb["notes"][: logits.shape[0]]))
    sweep = sweep_voicing_thresholds(setup, val_tracks)
    return dict(
        thresholds=sweep["thresholds"],
        va=sweep["va"],
        best_threshold=float(sweep["best_threshold"]),
    )


def separate_stereo_samples(imm: IMM, left: np.ndarray, right: np.ndarray,
                            setup: DecoderSetup, seed: int = 0) -> dict:
    """Full stereo separation chain (imm/tf_imm.py:354-618 + :720-739):

    1. mono NMF fit on the channel mean -> log-energy logits,
    2. Viterbi melody decode (shaun observation model, shaped decoding),
    3. melody-constrained sHF0 (half a semitone around the decoded bin),
    4. stereo NMF pass with per-channel gains (alphaL/R, betaL/R),
    5. Wiener-mask ISTFT resynthesis.

    Returns dict(melody=[n, 2], accompaniment=[n, 2] float32,
    states=[T] decoded states, voiced=[T] bool, sweeps=(mono, stereo)).
    """
    XL = imm.stft.stft(left)
    XR = imm.stft.stft(right)
    SXL = XL.abs() ** 2
    SXR = XR.abs() ** 2
    # the STFT is linear, so the mono-mix spectrum is the channel mean of
    # the spectra already computed: no third stft pass
    SX = (0.5 * (XL + XR)).abs() ** 2

    fit = imm.fit(SX, seed=seed)
    logits = imm_pitch_logits(imm.logits_from_fit(fit, SX))
    voiced, bins = setup.decode(logits)
    states = np.where(voiced, bins, imm.config.U).astype(np.int64)

    sHF0 = imm.constrained_HF0(fit["HF0"], states)
    stereo = imm.fit_stereo(SXL, SXR, sHF0, seed=seed)
    sep = imm.separate_stereo(XL, XR, stereo)

    n = len(left)

    def pair(key):
        yL, yR = sep[key]
        return np.stack([yL[:n], yR[:n]], axis=1).astype(np.float32)

    return dict(
        melody=pair("melody"),
        accompaniment=pair("accompaniment"),
        states=states,
        voiced=voiced,
        sweeps=(fit["sweeps"], stereo["sweeps"]),
    )


def original_states(imm: IMM, fits) -> list[np.ndarray]:
    """The 'original' method's decode of each fit's raw HF0 salience
    (imm/tf_imm.py:680-704): process_HF0's log observations, the analytic
    transition's log(A.T) (float64, then float32, as the reference and the
    JAX package take it) and a uniform log init, all tracks in one batch
    through the dense kernels (K3 -> the first-max argmax -> K4 on the
    card). fits: the fit dicts -> [T_i] int64 states."""
    U = imm.config.U
    log_B = np.log(imm.transition_matrix.T).astype(np.float32)
    log_pi = np.full(U + 1, -np.log(U + 1), np.float32)
    obs = [imm.process_HF0(fit["HF0"]).T.astype(np.float32) for fit in fits]  # [N_i, U+1]
    lengths = np.array([len(o) for o in obs], np.int32)
    staged = np.zeros((len(obs), lengths.max(), U + 1), np.float32)
    for i, o in enumerate(obs):
        staged[i, : lengths[i]] = o
    log_obs = torch.from_numpy(staged).to(imm.device)
    t1_last, t1m1 = dense_forward(log_B, log_pi, log_obs, lengths)
    last = torch.argmax(t1_last, dim=1).to(torch.int32)  # the first maximum
    states = dense_backtrace(log_B, t1m1, last, lengths).cpu().numpy()
    return [states[i, :L].astype(np.int64) for i, L in enumerate(lengths)]


def evaluate_imm_original(imm: IMM, fits_and_labels) -> dict:
    """The reference's 'original' IMM method (imm/tf_imm.py:680-776 +
    MetricsOriginal in imm/main_imm.py): decode the raw HF0 salience with
    the analytic transition and uniform init (`original_states`), then
    voice by the cumulative-energy threshold; score with the
    mir_eval-semantics metrics.

    fits_and_labels: list of dicts with SX [N, F], fit result dict, notes,
    original{times, freqs}.
    """
    all_states = original_states(imm, [item["fit"] for item in fits_and_labels])
    oas = []
    for item, states in zip(fits_and_labels, all_states):
        voicing = imm.voicing_detection(item["SX"], item["fit"], states)
        f0s = imm.melody_f0s(states, voicing)
        est_freqs = np.where(voicing, f0s, -np.maximum(f0s, imm.f0s[0]))
        est_times = np.arange(len(f0s)) * imm.config.h / imm.config.fs
        m = evaluate_melody(item["original"]["times"], item["original"]["freqs"],
                            est_times, est_freqs)
        oas.append(m["Overall Accuracy"])
    return dict(oas=oas, mean_oa=float(np.mean(oas)))


if __name__ == "__main__":
    main()
