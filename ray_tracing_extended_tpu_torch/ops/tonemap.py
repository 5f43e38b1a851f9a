"""Display transforms.

Mirrors ``ray_tracing_extended_tpu/ops/tonemap.py``: the reference blits
its clamped linear accumulator straight to screen, so ``to_srgb8`` applies
the sRGB transfer, optionally after an HDR curve.
"""

from __future__ import annotations

import torch

from . import vecmath as vm


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 transfer of linear values clamped to [0, 1]."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308,
        x * 12.92,
        1.055 * vm.pow(x, 1.0 / 2.4) - 0.055,
    )


def reinhard(x: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """Simple HDR -> LDR curve for unclamped accumulation."""
    x = x * exposure
    return x / (1.0 + x)


def aces(x: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """ACES filmic approximation (Narkowicz 2015 public fit)."""
    x = x * exposure
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def to_srgb8(img: torch.Tensor, tone: str = "none", exposure: float = 1.0):
    """Linear (H, W, 3) -> uint8 sRGB, optionally tone-mapped first."""
    if tone == "reinhard":
        img = reinhard(img, exposure)
    elif tone == "aces":
        img = aces(img, exposure)
    elif tone != "none":
        raise ValueError(f"unknown tone mode {tone!r}")
    srgb = linear_to_srgb(img)
    return (srgb * 255.0 + 0.5).to(torch.uint8)
