"""Drivers: one module a kind of traffic (decode, transcribe), each
with a class `Driver(config, traffic, seed, device)`:

- `setup()`: the inputs and weights from the seed, the program's objects,
  every shape the cell uses warmed up;
- `run(seconds, recorder) -> {end-to-end metric: value}`: the measured
  window, with `attempted` and `failed` set;
- `layer_view(recorder) -> View`: what the per-layer readers read;
- `release()`: the program's state freed, its outputs kept;
- `check(candidate=None) -> {number: value}`: the program's outputs (or a
  candidate's, e.g. the control's) against the reference;
- `control()`: the candidate computed by the reference one precision step
  below the configuration's (the check that the comparison can fail).
"""

from __future__ import annotations

import dataclasses

from ..tracing import Recorder


@dataclasses.dataclass
class View:
    """What a per-layer reader sees of one traced run."""

    rec: Recorder
    config: dict
    traffic: dict
    records: list  # one dict a request or step of the window
    extra: dict  # driver-computed quantities (flops a frame, ...)

    @property
    def trace(self):
        return self.rec.result

    def span_share(self, name: str) -> float | None:
        """Percent of the window spent in the benchmark's spans `name`."""
        if name not in self.rec.spans:
            return None
        return 100.0 * self.rec.total(name) / self.rec.window_s

    def idle_share(self) -> float | None:
        t = self.trace
        return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)

