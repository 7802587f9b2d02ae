"""A checkout root of tiny cells for the CPU tests, defined only by data:
its own BENCHMARK.json, configurations, traffic mixes and limits."""

from __future__ import annotations

import json
from pathlib import Path

TINY_TONET = {"freq_bin": 360, "tone_class": 12, "octave_class": 6, "attn_dim": 32, "seg_frame": 128}


def write_root(tmp: Path, limits: dict | None = None) -> Path:
    real = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    tonet = json.loads((Path(__file__).resolve().parents[1] / "configs" / "tonet.json").read_text())
    tonet = dict(tonet, name="tiny_tonet", model_kwargs=TINY_TONET, reduced=["attn_dim"])
    jdc = json.loads((Path(__file__).resolve().parents[1] / "configs" / "jdc.json").read_text())
    jdc = dict(jdc, name="tiny_hmm", reduced=["n_bins"],
               hmm=dict(jdc["hmm"], n_bins=60, d_max=6, spw=5))
    lengths = {"min": 60, "mode": 150, "max": 300, "length_seed": 7}
    traffic = {
        "tiny_decode": {"driver": "decode", "batch": 8, "pool_requests": 2,
                        "lengths": dict(lengths, min=1000, mode=3000, max=8000),
                        "logits": {"mean": -4.0, "std": 1.0, "peak": 8.0, "step": 2,
                                   "run_frames": 20, "voiced": 0.7},
                        "check": {"requests": 2}},
        "tiny_transcribe": {"driver": "transcribe", "pool_tracks": 2, "voicing_threshold": 0.01,
                            "lengths": dict(lengths, mode=200, max=260), "check": {"tracks": 2}},
    }
    cells = {
        "tiny.decode": ("tiny_hmm", "tiny_decode", {"path_gap": 1e-4}),
        "tiny.transcribe": ("tiny_tonet", "tiny_transcribe", {"logit_gap": 1e-4, "path_gap": 1e-4}),
    }
    (tmp / "perfbench" / "configs").mkdir(parents=True)
    (tmp / "perfbench" / "traffic").mkdir()
    (tmp / "perfbench" / "limits").mkdir()
    for cfg in (tonet, jdc):
        (tmp / "perfbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, t in traffic.items():
        (tmp / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, (_, _, lim) in cells.items():
        lim = (limits or {}).get(name, lim)
        (tmp / "perfbench" / "limits" / f"{name}.json").write_text(json.dumps({"limits": lim}))

    def mine(m):
        kinds = {w.split(".", 1)[1] for w in m["workloads"]}
        return dict(m, workloads=[n for n in cells if n.split(".", 1)[1] in kinds])

    bench = {
        "command": real["command"], "paths": real["paths"], "run_seconds": 1,
        "configs": [{"name": c["name"], "source": "https://example.org/tiny",
                     "file": f"perfbench/configs/{c['name']}.json", "reduced": c["reduced"],
                     "why": "tiny"} for c in (tonet, jdc)],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                      for n, (c, t, _) in cells.items()],
        "end_to_end": [mine(m) if "workloads" in m else m for m in real["end_to_end"]],
        "per_layer": [mine(m) for m in real["per_layer"]],
    }
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
