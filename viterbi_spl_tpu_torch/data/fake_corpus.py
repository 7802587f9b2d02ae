"""Synthetic on-disk corpus trees in the exact layouts the readers expect
(counterpart of viterbi_spl_tpu/data/fake_corpus.py: for the same arguments
every file it writes is the JAX package's, byte for byte).

Writes medleydb (MIX wavs + MELODY2 csv + SOURCEID lab), adc04/mirex05
REF txt, mir1k Wavfile + PitchLabel .pv, the RWC 7-disk aiff walk + AIST
MELODY.TXT, and the tonet $fatnet_spec/f0ref grid — everything the
real-data readers consume (dcnet/softmax_viterbi.py:860-1503 dataset
classes; apps/*/build_real_datasets / build_external_eval_datasets).

Its users: the port's real-data drills (tests/test_torch_drill*.py on
tiny 2 s tracks, and chip_smoke.py's real-data phase on the card), which
prove the real-data chains execute. rich=True renders harmonically rich
melodies (5 partials) on mean-reverting pitch walks confined to the
families' shared note range, so the CFP/STFT features carry a real f0
ridge the acoustic models can fit (a learnable corpus); hard=True adds
the distractors of the hard regime (`render`).

The two CFP frame counts the annotations are sized to (MELODY2 rows and
the f0ref rows) come from the port's CFP on `device` (CUDA unless the
caller asks for the CPU); a frame count depends only on a signal's length.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

from .splits import adc04_track_ids, medleydb_splits
from ..frontend import CFP, MSNET_CFP, TONET_CFP
from ..io.wav import load_wav

SR44 = 44100
HOP_256 = 256.0 / 44100.0


def write_wav(path: Path, samples, sr: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(sr)
        fh.writeframes(pcm.tobytes())


def write_aiff(path: Path, samples, sr: int) -> None:
    """Minimal mono PCM16 AIFF (FORM/COMM/SSND) matching io/wav.py's
    parser; sample rate as an 80-bit extended float."""
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype(">i2").tobytes()
    frames = len(samples)
    # 80-bit extended: sr = mant / 2^63 * 2^(exp - 16383)
    exp = 16383 + 15  # 44100 = 1.345... * 2^15
    mant = int(sr) << 48
    comm = struct.pack(">hIh", 1, frames, 16) + struct.pack(">HQ", exp, mant)
    ssnd = struct.pack(">II", 0, 0) + pcm
    body = (
        b"AIFF"
        + b"COMM" + struct.pack(">I", len(comm)) + comm
        + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    )
    with open(path, "wb") as fh:
        fh.write(b"FORM" + struct.pack(">I", len(body)) + body)


def melody(n_frames: int, hop_seconds: float, seed: int, f0: float = 220.0,
           rich: bool = False) -> np.ndarray:
    """A wandering per-frame frequency track with unvoiced stretches.

    rich=True: mean-reverting pitch walk (OU-style) around a per-track
    center inside MIDI [48, 72], confined to [45, 75] — within every
    family's note grid (jdc clamps to [38-2/16, 83+2/16],
    jdc/kum_m2m3.py:289-341; msnet/dcnet grids start near MIDI 23) — and
    longer voiced phrases, so a model can learn the f0 -> bin mapping.

    The walk is calibrated PER SECOND (~5 semitones/s RMS), not per
    frame: a per-frame step at a 5.8 ms hop would wander ~40 st/s,
    spreading the estimated voiced-transition distribution over many
    bins and destroying the Viterbi prior's information (observed in the
    round-4 drill: the decode tipped unvoiced on borderline frames).
    """
    rng = np.random.default_rng(seed)
    if rich:
        center = rng.uniform(55.0, 65.0)
        notes = np.empty(n_frames)
        x = center + rng.uniform(-2, 2)
        drift = 2.0 * hop_seconds  # ~0.5 s mean-reversion time constant
        sigma = 5.0 * hop_seconds  # smooth: ~5 st/s max slope from noise
        for k in range(n_frames):
            x += drift * (center - x) + rng.normal() * sigma
            notes[k] = x
        t = np.arange(n_frames) * hop_seconds
        # a glide widens the in-track range while keeping per-frame steps
        # tiny (max slope 2pi*0.4*2.5 ~ 6 st/s), and a very slow LARGE
        # sweep makes every track cover most of the singing range — the
        # non-equivariant families (jdc's BiLSTM/dense heads) cannot
        # generalize across pitch from 2 narrow-center training tracks
        notes = notes + 2.5 * np.sin(
            2 * np.pi * 0.4 * t + rng.uniform(0, 2 * np.pi)
        )
        notes = notes + rng.uniform(5.0, 8.0) * np.sin(
            2 * np.pi * rng.uniform(0.03, 0.07) * t
            + rng.uniform(0, 2 * np.pi)
        )
        notes = np.clip(notes, 45.0, 75.0)
        freqs = 440.0 * 2.0 ** ((notes - 69.0) / 12.0)
        phrase = max(int(0.5 / hop_seconds), 8)  # ~0.5 s voicing phrases
        voiced = np.repeat(
            rng.random(n_frames // phrase + 1) > 0.25, phrase
        )[:n_frames]
    else:
        steps = rng.integers(-1, 2, n_frames).astype(np.float64) * 0.3
        freqs = f0 * 2.0 ** (np.cumsum(steps) / 12.0)
        voiced = np.repeat(
            rng.random(n_frames // 25 + 1) > 0.3, 25
        )[:n_frames]
    return np.where(voiced, freqs, 0.0)


def _accompaniment(n_frames: int, hop_seconds: float, center_midi: float,
                   rng) -> np.ndarray:
    """Piecewise-constant chord-tone track around the melody's center —
    the harmonic distractor of the hard regime. Notes jump between
    third/fifth/octave offsets every ~0.4 s, so the distractor's pitch
    DYNAMICS differ from the smooth melody: the shaped Viterbi prior
    (d_max-banded transitions, hmm/params.py) forbids the bin jumps the
    distractor induces, which is exactly the mechanism the reference's
    positive w/-Viterbi deltas rely on (dcnet/softmax_viterbi.py:55-84)."""
    offsets = np.array([-12.0, -5.0, 4.0, 7.0, 12.0])
    hold = max(int(0.4 / hop_seconds), 4)
    n_holds = n_frames // hold + 1
    notes = np.repeat(center_midi + rng.choice(offsets, n_holds), hold)
    return 440.0 * 2.0 ** ((notes[:n_frames] - 69.0) / 12.0)


def _pink_noise(length: int, rng) -> np.ndarray:
    """1/f-shaped broadband noise (unit RMS) via spectral shaping."""
    spec = np.fft.rfft(rng.normal(size=length))
    f = np.arange(len(spec), dtype=np.float64)
    f[0] = 1.0
    pink = np.fft.irfft(spec / np.sqrt(f), n=length)
    return pink / (np.std(pink) + 1e-12)


def render(freqs: np.ndarray, hop_seconds: float, sr: int, length: int,
           rich: bool = False, hard: bool = False, seed: int = 0) -> np.ndarray:
    """Additive rendering of a per-frame frequency track; rich=True adds
    5 partials at 1/k amplitude (a crude glottal-ish spectrum) so the
    CFP's cepstral channels see real harmonic structure.

    hard=True (implies rich) degrades the mixture into the regime the
    reference's accuracy tables live in (raw OA ~0.7-0.85, where Viterbi
    smoothing pays for itself):
    - ~5 Hz tremolo on the melody voice (depth 0.75): the weak phases are
      where the acoustic model flips to a distractor bin for a few frames,
    - an always-on chord-tone accompaniment (odd partials only — a
      different timbre, so voicing IS learnable when the melody rests),
    - broadband white + pink noise at ~20x the clean-regime level.
    Labels stay the melody voice only, like a real MIX stem."""
    rng = np.random.default_rng(10_000 + seed)
    t_frames = np.arange(len(freqs)) * hop_seconds
    t = np.arange(length) / sr
    f = np.interp(t, t_frames, np.where(freqs > 0, freqs, 0.0))
    phase = 2 * np.pi * np.cumsum(f) / sr
    gate = np.interp(t, t_frames, (freqs > 0).astype(np.float64))
    if rich or hard:
        sig = np.zeros(length)
        for k in range(1, 6):
            # drop partials above Nyquist (mir1k renders at 16 kHz)
            alias = np.interp(t, t_frames, (freqs * k < sr / 2).astype(float))
            sig += (0.35 / k) * np.sin(k * phase) * alias
        sig = sig * gate
        if hard:
            # tremolo: weak phases every ~200 ms where the melody nearly
            # vanishes under the accompaniment. Gains are the v2
            # calibration: v1 (0.75/0.30/0.02+0.04) saturated to val OA
            # 0.95+ at the FULL training budget — full-scale training
            # learns shallow degradation too well, so difficulty must be
            # calibrated at full budget (--small underestimates).
            trem = 1.0 - 0.92 * 0.5 * (
                1.0 + np.sin(2 * np.pi * rng.uniform(4.0, 6.0) * t
                             + rng.uniform(0, 2 * np.pi))
            )
            sig = sig * trem
            voiced = freqs > 0
            if np.any(voiced):
                center = float(np.median(
                    69.0 + 12.0 * np.log2(freqs[voiced] / 440.0)
                ))
            else:
                center = 60.0
            acc = _accompaniment(len(freqs), hop_seconds, center, rng)
            acc_f = np.interp(t, t_frames, acc)
            acc_phase = 2 * np.pi * np.cumsum(acc_f) / sr
            acc_sig = np.zeros(length)
            for k in (1, 3, 5):  # odd partials: a distinguishable timbre
                alias = np.interp(t, t_frames, (acc * k < sr / 2).astype(float))
                acc_sig += (0.45 / k) * np.sin(k * acc_phase) * alias
            # slow AM on the accompaniment at an incommensurate rate, so
            # the melody/distractor dominance keeps trading places
            acc_am = 0.65 + 0.35 * np.sin(
                2 * np.pi * rng.uniform(0.7, 1.3) * t
                + rng.uniform(0, 2 * np.pi)
            )
            sig = sig + acc_sig * acc_am
            sig += 0.04 * rng.normal(size=length)
            sig += 0.08 * _pink_noise(length, rng)
        else:
            sig += 0.005 * np.random.default_rng(0).normal(size=length)
    else:
        sig = 0.5 * np.sin(phase) * gate
        sig += 0.01 * np.random.default_rng(0).normal(size=length)
    return sig.astype(np.float32)


def generate_fake_corpus(
    root: Path,
    duration: float = 2.0,
    ext_duration: float | None = None,
    rwc_duration: float = 1.0,
    rich: bool = False,
    hard: bool = False,
    device=None,
) -> dict[str, str]:
    """Write every corpus tree under `root`; returns the env-root dict
    (medleydb/melody2_dir/section_dir/adc04/mirex05/mir1k/rwc/fatnet_spec)
    to point the dataset readers at. Each split's first two tracks carry
    real audio — the slice the apps' --debug mode reads. The CFPs that size
    the annotations run on `device`."""
    root = Path(root)
    rich = rich or hard  # hard regime renders rich melodies + distractors
    ext_duration = duration if ext_duration is None else ext_duration
    cfp = CFP(MSNET_CFP, device=device)
    L44 = int(duration * SR44)

    # ---- medleydb: MIX wavs + MELODY2 csv + SOURCEID lab ----
    mdb = root / "medleydb"
    mel2 = root / "melody2"
    sect = root / "sections"
    mel2.mkdir(parents=True, exist_ok=True)
    sect.mkdir(parents=True, exist_ok=True)
    splits = medleydb_splits()
    tids = [t for split in splits.values() for t in split[:2]]
    n_mel = None
    for i, tid in enumerate(tids):
        n_guess = int(np.ceil(L44 / 256)) + 1
        freqs = melody(n_guess, HOP_256, seed=i, rich=rich)
        samples = render(freqs, HOP_256, SR44, L44, rich=rich, hard=hard,
                         seed=i)
        write_wav(mdb / tid / f"{tid}_MIX.wav", samples, SR44)
        if n_mel is None:
            # size the annotation to the actual CFP frame count once
            # (reconcile_lengths allows 0 <= n_mel - T_spec <= 1)
            T_cfp = cfp.features(samples).shape[0]
            assert 0 <= n_guess - T_cfp <= 1, (n_guess, T_cfp)
            n_mel = n_guess
        times = np.arange(n_mel) * HOP_256
        with open(mel2 / f"{tid}_MELODY2.csv", "w") as fh:
            for t, f in zip(times, freqs[:n_mel]):
                fh.write(f"{float(t)!r},{float(f)!r}\n")
        with open(sect / f"{tid}_SOURCEID.lab", "w") as fh:
            fh.write("start_time,end_time,instrument_label\n")
            fh.write(f"0.0,{float(duration)!r},female singer\n")

    # ---- adc04: wav + REF.txt on the 256-hop grid ----
    adc = root / "adc04"
    Le = int(ext_duration * SR44)
    n_ext = int(np.ceil(Le / 256)) + 1
    for i, tid in enumerate(adc04_track_ids()[:2]):
        freqs = melody(n_ext, HOP_256, seed=100 + i, rich=rich)
        samples = render(freqs, HOP_256, SR44, Le, rich=rich, hard=hard,
                         seed=100 + i)
        write_wav(adc / f"{tid}.wav", samples, SR44)
        with open(adc / f"{tid}REF.txt", "w") as fh:
            for k in range(n_ext):
                fh.write(f"{float(k * HOP_256)!r} {float(freqs[k])!r}\n")

    # ---- mirex05: wav + REF.txt on the 10 ms grid ----
    mrx = root / "mirex05"
    n_10ms = int(ext_duration / 0.01)
    for i, tid in enumerate(("train01", "train02")):
        freqs = melody(n_10ms, 0.01, seed=200 + i, rich=rich)
        samples = render(freqs, 0.01, SR44, Le, rich=rich, hard=hard,
                         seed=200 + i)
        write_wav(mrx / f"{tid}.wav", samples, SR44)
        with open(mrx / f"{tid}REF.txt", "w") as fh:
            for k in range(n_10ms):
                fh.write(f"{float(k * 0.01)!r} {float(freqs[k])!r}\n")

    # ---- mir1k: 16 kHz Wavfile + PitchLabel .pv (MIDI at 20 ms) ----
    m1k = root / "mir1k"
    L16 = int(ext_duration * 16000)
    n_pv = (L16 - 640) // 320 + 1
    for i, tid in enumerate(("abjones_1_01", "abjones_1_02")):
        freqs = melody(n_pv, 0.02, seed=300 + i, rich=rich)
        samples = render(freqs, 0.02, 16000, L16, rich=rich, hard=hard,
                         seed=300 + i)
        write_wav(m1k / "Wavfile" / f"{tid}.wav", samples, 16000)
        pitches = np.where(
            freqs > 0,
            69.0 + 12.0 * np.log2(np.maximum(freqs, 1) / 440.0),
            0.0,
        )
        (m1k / "PitchLabel").mkdir(exist_ok=True)
        np.savetxt(m1k / "PitchLabel" / f"{tid}.pv", pitches, fmt="%.6f")

    # ---- rwc: 7-disk aiff walk (100 recordings) + AIST MELODY.TXT ----
    rwc = root / "rwc"
    La = int(rwc_duration * SR44)
    per_disk = [15, 15, 15, 15, 15, 15, 10]
    rec = 0
    tone = render(melody(100, 0.01, seed=999), 0.01, SR44, min(La, SR44))
    for disk, count in enumerate(per_disk, start=1):
        ddir = rwc / "popular" / f"RWC-MDB-P-2001-M0{disk}"
        for within in range(1, count + 1):
            # recordings 0 and 1 (the debug slice) get real audio, the
            # rest only need to exist for the 7-disk walk
            if rec < 2:
                freqs = melody(int(rwc_duration / 0.01), 0.01,
                               seed=400 + rec, rich=rich)
                samples = render(freqs, 0.01, SR44, La, rich=rich,
                                 hard=hard, seed=400 + rec)
            else:
                samples = tone[:256]
            write_aiff(ddir / f"{within} FakeSong.aiff", samples, SR44)
            rec += 1
    melody_dir = rwc / "popular" / "AIST.RWC-MDB-P-2001.MELODY"
    melody_dir.mkdir(parents=True, exist_ok=True)
    for rec_idx in range(2):
        freqs = melody(int(rwc_duration / 0.01), 0.01, seed=400 + rec_idx,
                       rich=rich)
        with open(melody_dir / f"RM-P{rec_idx + 1:03d}.MELODY.TXT", "w") as fh:
            for k, f in enumerate(freqs):
                if f > 0:
                    fh.write(f"{k} {k} m {f:.3f} 0\n")

    # ---- tonet yu labels: $fatnet_spec/f0ref on the strict 10 ms grid ----
    # (tonet/main_shaun.py:386-406 gen_label_yu_fn); row count is pinned to
    # the actual tonet-CFP frame count so reconcile_lengths accepts them
    f0ref = root / "fatnet" / "f0ref"
    f0ref.mkdir(parents=True, exist_ok=True)
    tonet_cfp = CFP(TONET_CFP, device=device)
    samples8, _ = load_wav(str(mdb / tids[0] / f"{tids[0]}_MIX.wav"), sr=8000)
    n_f0 = tonet_cfp.features(samples8).shape[0] + 1
    for i, tid in enumerate(tids):
        freqs = melody(n_f0, 0.01, seed=500 + i, rich=rich)
        with open(f0ref / f"{tid}_MIX.txt", "w") as fh:
            for k in range(n_f0):
                fh.write(f"{k * 0.01:.2f} {float(freqs[k])!r}\n")

    return dict(
        medleydb=str(mdb), melody2_dir=str(mel2), section_dir=str(sect),
        adc04=str(adc), mirex05=str(mrx), mir1k=str(m1k), rwc=str(rwc),
        fatnet_spec=str(root / "fatnet"),
    )
