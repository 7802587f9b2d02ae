"""Reporting: markdown metric tables, JSONL logs, piano-roll figures
(counterpart of viterbi_spl_tpu/harness/reporting.py).

Re-design of the reference's observability stack (SURVEY.md §5):
- ArrayToTableTFFn markdown tables of per-recording metrics + average
  (self_defined/array_to_tf_table.py:5-67, used at
  dcnet/softmax_viterbi.py:3232-3355) -> plain markdown strings,
- TensorBoard scalars -> JSONL event log (loadable anywhere),
- piano-roll reference/viterbi/raw comparison figures
  (dcnet/softmax_viterbi.py:3200-3230) and npz dumps for paper figures
  (dcnet/lontano.py).

matplotlib (the figures) and torch.utils.tensorboard (the mirror) are
imported only when a figure or the mirror is asked for: a training run
needs neither.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..metrics.melody import METRIC_NAMES


def metrics_markdown_table(
    results: dict, rec_names: list[str], metric_names=METRIC_NAMES
) -> str:
    """Per-recording metric table + average row, as markdown."""
    header = "| recording | " + " | ".join(metric_names) + " |"
    sep = "|" + "---|" * (len(metric_names) + 1)
    lines = [header, sep]
    cols = [np.asarray(results[m]) for m in metric_names]
    for i, name in enumerate(rec_names):
        cells = " | ".join(f"{col[i]:.4f}" for col in cols)
        lines.append(f"| {name} | {cells} |")
    avg = " | ".join(f"{col.mean():.4f}" for col in cols)
    lines.append(f"| **average** | {avg} |")
    return "\n".join(lines)


class Reporter:
    """Append-only JSONL event log + artifact directory.

    With tensorboard=True, every scalar/text event is mirrored into
    TensorBoard event files in the same directory (via
    torch.utils.tensorboard — no TF dependency), reproducing the
    reference's TBSummary surface: tf.summary.scalar for loss/oa/
    voicing_threshold and tf.summary.text markdown metric tables
    (dcnet/softmax_viterbi.py:3232-3355)."""

    def __init__(self, log_dir: str | Path, tensorboard: bool = False):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._events = self.dir / "events.jsonl"
        self._tb = None
        if tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=str(self.dir))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(dict(kind="scalar", tag=tag, value=float(value), step=step))
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
            self._tb.flush()

    def text(self, tag: str, text: str, step: int = 0) -> None:
        self._write(dict(kind="text", tag=tag, text=text, step=step))
        if self._tb is not None:
            self._tb.add_text(tag, text, step)
            self._tb.flush()

    def table(self, tag: str, results: dict, rec_names: list[str], step: int = 0):
        self.text(tag, metrics_markdown_table(results, rec_names), step)

    def _write(self, event: dict) -> None:
        event["time"] = time.time()
        with open(self._events, "a") as fh:
            fh.write(json.dumps(event) + "\n")

    def read_events(self) -> list[dict]:
        if not self._events.exists():
            return []
        with open(self._events) as fh:
            return [json.loads(line) for line in fh]

    def close(self) -> None:
        """Release the TensorBoard writer (file handle + async thread).
        The JSONL log needs no teardown (opened per write)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def piano_roll_figure(
    path: str | Path,
    ref_notes: np.ndarray,
    viterbi_notes: np.ndarray,
    viterbi_voicing: np.ndarray,
    raw_notes: np.ndarray,
    raw_voicing: np.ndarray,
    title: str = "",
) -> None:
    """Three-panel reference / viterbi / raw scatter comparison
    (dcnet/softmax_viterbi.py:3200-3230 / effect_of_viterbi_fn)."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    ref = np.where(ref_notes > 0, ref_notes, np.nan)
    vit = np.where(viterbi_voicing, viterbi_notes, np.nan)
    raw = np.where(raw_voicing, raw_notes, np.nan)

    fig, axes = plt.subplots(3, sharex=True)
    x = np.arange(len(ref))
    for ax, name, y in zip(axes, ("reference", "viterbi", "w/o viterbi"), (ref, vit, raw)):
        ax.scatter(x, y, s=0.5, c="k")
        ax.set_ylabel(name)
        ax.set_xticks([])
        ax.set_yticks([])
    axes[-1].set_xlabel("time")
    if title:
        fig.suptitle(title)
    fig.savefig(path)
    plt.close(fig)


def dump_track_npz(
    path: str | Path,
    **arrays: np.ndarray,
) -> None:
    """npz dump for paper figures (dcnet/lontano.py's shaun_<track>.npz)."""
    np.savez(path, **arrays)
