"""Procedural sky / ground / sun environment light.

Mirrors ``ray_tracing_extended_tpu/ops/environment.py``
(GetEnvironmentLight, RayTracing.shader:238-251), including the quirk that
the sun only lights directions fully above the horizon.
"""

from __future__ import annotations

import torch

from ..models.geometry import Environment
from . import vecmath as vm


def environment_light(d: torch.Tensor, env: Environment) -> torch.Tensor:
    """Environment radiance for ray directions ``d`` (B, 3) -> (B, 3)."""
    dy = d[..., 1]
    sky_t = vm.pow(vm.smoothstep(0.0, 0.4, dy), 0.35)
    ground_t = vm.smoothstep(-0.01, 0.0, dy)
    sky = vm.lerp(
        env.sky_colour_horizon[None, :],
        env.sky_colour_zenith[None, :],
        sky_t[..., None],
    )
    sun = (
        vm.pow(torch.clamp(vm.dot(d, env.sun_dir[None, :]), min=0.0),
               env.sun_focus)
        * env.sun_intensity
    )
    composite = vm.lerp(env.ground_colour[None, :], sky, ground_t[..., None])
    composite = composite + (sun * (ground_t >= 1.0))[..., None]
    return composite * env.enabled
