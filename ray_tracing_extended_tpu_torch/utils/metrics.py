"""Per-frame render metrics as JSON lines.

Counterpart of ``ray_tracing_extended_tpu/utils/metrics.py``, with the
same keys: ``frame``, ``wall_s``, ``mrays_per_s`` (live segments / wall),
``spp_per_s``, ``rays_per_path``, plus what ``progressive`` puts in
``extra``: ``alive_frac`` (live-path fraction per bounce index, from the
renderer's bounce histogram), ``accum_var`` (the Welford variance of the
running average over n(n - 1), the Monte-Carlo convergence signal) and,
for fused launches, ``batched_frames``.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field


@dataclass
class FrameMetrics:
    frame: int
    wall_s: float
    rays: int
    pixels: int
    spp: int
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "frame": self.frame,
            "wall_s": round(self.wall_s, 5),
            # 6 digits keep a tiny frame's throughput above 0
            "mrays_per_s": round(self.rays / self.wall_s / 1e6, 6)
            if self.wall_s > 0
            else None,
            "spp_per_s": round(self.spp / self.wall_s, 3)
            if self.wall_s > 0
            else None,
            "rays_per_path": round(self.rays / (self.pixels * self.spp), 4),
        }
        d.update(self.extra)
        return d


class MetricsLogger:
    """Writes one JSON line per frame (or fused chunk) to a file, appending,
    and with ``echo`` to standard error."""

    def __init__(self, path=None, echo: bool = False):
        self._fh = open(path, "a") if path else None
        self._echo = echo

    def log(self, m: FrameMetrics) -> None:
        line = json.dumps(m.to_dict())
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
