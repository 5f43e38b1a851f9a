"""PCG-hash RNG, bit-exact to the reference shader and to the JAX package.

Mirrors ``ray_tracing_extended_tpu/ops/rng.py`` (RayTracing.shader:193-230,
seed layout :358-362). A state is an int64 tensor holding a uint32 value
in [0, 2^32): the products below stay under 2^62, so masking the low 32
bits after each multiply-add is the exact uint32 wraparound, and ``>>`` on
a masked non-negative int64 is the logical shift. (torch's int32 shifts
are arithmetic, and ``torch.uint32`` supports few operations.)

Every sampler returns ``(new_state, value)``; vector samplers stack on a
trailing axis.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vecmath as vm

_MASK = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_OUT_MUL = 277803737

# Frame-seed stride (RayTracing.shader:362).
FRAME_SEED_STRIDE = 719393

# The shader's two PIs: RandomPointInCircle's 3.1415 (RayTracing.shader:35)
# and Box-Muller's 3.1415926 (RayTracing.shader:210).
PI_LOWP = float(np.float32(3.1415))
PI_BOXMULLER = float(np.float32(3.1415926))
# The fast scatter sampler's angle scale, f32(2 * 3.14159265), as the TPU
# kernel's _rand_unit3_fast spells it (a third constant, not 2 * the above).
TWO_PI_FAST = float(np.float32(2.0 * 3.14159265))

# f32(1) / f32(2^32 - 1): the f32 literal rounds to 2^32, as in HLSL.
INV_U32_MAX = float(np.float32(1.0) / np.float32(4294967295.0))


def seed(pixel_index: torch.Tensor, frame) -> torch.Tensor:
    """``pixelIndex + frame * 719393`` in uint32 wraparound; ``frame`` is a
    number or an integer tensor (one frame a lane)."""
    if isinstance(frame, torch.Tensor):
        frame = frame.long() & _MASK
    else:
        frame = int(frame) & _MASK
    return (pixel_index.long() + frame * FRAME_SEED_STRIDE) & _MASK


def next_random(state: torch.Tensor):
    """One PCG step. Returns ``(new_state, uint32 output)`` as int64."""
    state = (state * _MUL + _INC) & _MASK
    shift = (state >> 28) + 4
    result = (((state >> shift) ^ state) * _OUT_MUL) & _MASK
    result = (result >> 22) ^ result
    return state, result


def random_value(state: torch.Tensor):
    """Uniform f32 in [0, 1]: ``NextRandom / (2^32 - 1)``; the u32 -> f32
    conversion rounds to nearest, as XLA's does."""
    state, bits = next_random(state)
    return state, bits.to(torch.float32) * INV_U32_MAX


def random_value_normal(state: torch.Tensor):
    """Standard normal via Box-Muller (cos branch), two draws. Keeps the
    reference's ``log(0) = -inf`` rather than clamping."""
    state, r1 = random_value(state)
    state, r2 = random_value(state)
    theta = (2.0 * PI_BOXMULLER) * r1
    rho = vm.sqrt(-2.0 * vm.log(r2))
    return state, rho * vm.cos(theta)


def random_direction(state: torch.Tensor):
    """Uniform unit vector: a normalized 3-D Gaussian, six draws."""
    state, x = random_value_normal(state)
    state, y = random_value_normal(state)
    state, z = random_value_normal(state)
    inv_len = vm.rsqrt(x * x + y * y + z * z)
    return state, torch.stack([x * inv_len, y * inv_len, z * inv_len], dim=-1)


def random_direction_fast(state: torch.Tensor):
    """Uniform unit vector by the (z, phi) area-preserving map, two draws:
    ``z = 2u - 1``, ``phi = v * f32(2 * 3.14159265)``,
    ``(s cos phi, s sin phi, z)`` with ``s = sqrt(max(1 - z^2, 0))``.
    The counterpart of the TPU kernel's ``_rand_unit3_fast``
    (``cfg.fast_scatter``): the same distribution as ``random_direction``
    from a different draw sequence."""
    state, u = random_value(state)
    state, v = random_value(state)
    z = u * 2.0 - 1.0
    phi = v * TWO_PI_FAST
    s = vm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return state, torch.stack([s * vm.cos(phi), s * vm.sin(phi), z], dim=-1)


def random_point_in_circle(state: torch.Tensor):
    """Uniform point in the unit disc, two draws: angle ``U * 2 * PI``
    (the shader's 3.1415), radius ``sqrt(U)``."""
    state, r1 = random_value(state)
    angle = r1 * 2.0 * PI_LOWP
    state, r2 = random_value(state)
    radius = vm.sqrt(r2)
    return state, torch.stack(
        [vm.cos(angle) * radius, vm.sin(angle) * radius], dim=-1
    )
