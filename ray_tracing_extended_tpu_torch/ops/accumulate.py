"""Progressive accumulation: the running average across frames.

Mirrors ``ray_tracing_extended_tpu/ops/accumulate.py`` (Accumulate.shader:
43-53): ``weight = 1 / (frame + 1)``, ``out = prev * (1 - weight) + cur *
weight``, then the reference's per-frame saturate in parity mode
(``clamp=True``) or unclamped HDR accumulation (``clamp=False``).
"""

from __future__ import annotations

import torch

from . import vecmath as vm


def frame_weight(frame) -> torch.Tensor:
    """``1 / (f32(frame) + 1)`` as a 0-d f32 tensor on the CPU."""
    return 1.0 / (torch.tensor(float(int(frame)), dtype=torch.float32) + 1.0)


def accumulate(prev: torch.Tensor, cur: torch.Tensor, frame, clamp: bool = True):
    """Fold frame ``frame``'s render ``cur`` into the running average
    ``prev``. At frame 0 the weight is 1, so ``prev`` is discarded."""
    weight = frame_weight(frame).to(cur.device)
    out = prev * (1.0 - weight) + cur * weight
    return vm.saturate(out) if clamp else out
