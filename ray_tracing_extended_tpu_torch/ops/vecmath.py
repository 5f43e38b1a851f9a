"""Vector math with HLSL intrinsic semantics on ``(..., 3)`` f32 tensors,
and the f32 transcendentals the plain path uses.

Mirrors ``ray_tracing_extended_tpu/ops/vecmath.py``. Dot products are
written out term by term, ``(x0*y0 + x1*y1) + x2*y2``, so the summation
order is fixed and no matrix unit (or TF32) takes part; the CUDA kernel
sums in the same order.

``sqrt``, ``rsqrt``, ``cos``, ``sin``, ``log`` and ``pow`` evaluate in
float64 and round to f32 on the CPU. PyTorch's vectorized f32 versions
there are not correctly rounded (its f32 ``sqrt`` differs from the
correctly rounded one on 0.6% of inputs) and were seen to change their
last bit between runs of the same program. Through float64 the CPU
results are deterministic and within half an ulp of the exact value. On a
CUDA device the f32 library functions (``sqrtf``, ``cosf``, ...) are the
ones the kernel calls, so they stay f32.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which rounds differently from XLA's division and the CUDA
    kernel's. Dividing by a 0-d tensor on ``x``'s device keeps the true
    division on the CPU and on the card alike."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _via_float64(fn, *args: torch.Tensor) -> torch.Tensor:
    if args[0].device.type == "cpu":
        return fn(*(a.double() for a in args)).float()
    return fn(*args)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return _via_float64(torch.sqrt, x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return _via_float64(torch.rsqrt, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    return _via_float64(torch.cos, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return _via_float64(torch.sin, x)


def log(x: torch.Tensor) -> torch.Tensor:
    return _via_float64(torch.log, x)


def pow(x: torch.Tensor, y) -> torch.Tensor:
    """``x ** y`` elementwise; a number ``y`` broadcasts as an f32 tensor
    (PyTorch special-cases some scalar exponents)."""
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    return _via_float64(torch.pow, x, y.expand_as(x))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """HLSL ``normalize``: ``v * rsqrt(dot(v, v))`` (inf/nan for a zero
    vector, like the shader)."""
    return v * rsqrt(dot(v, v))[..., None]


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL ``reflect``: ``i - 2 * dot(i, n) * n``."""
    return i - (2.0 * dot(i, n))[..., None] * n


def lerp(a, b, t):
    """HLSL ``lerp``: ``a + t * (b - a)`` (t may broadcast)."""
    return a + t * (b - a)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def smoothstep(lo: float, hi: float, x: torch.Tensor) -> torch.Tensor:
    """HLSL ``smoothstep``: cubic Hermite of the clamped normalized input."""
    t = torch.clamp(div(x - lo, hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def saturate(x: torch.Tensor) -> torch.Tensor:
    """HLSL ``saturate``: clamp to [0, 1]."""
    return torch.clamp(x, 0.0, 1.0)
