"""Material response: checker / invisible-light flags, the specular-lottery
scatter and the dielectric extension.

Mirrors ``ray_tracing_extended_tpu/ops/materials.py`` (Trace,
RayTracing.shader:309-342). A dielectric reuses the specular-lottery draw
as its Fresnel choice, so every scattering lane takes the same 7 draws
(3 with ``fast_scatter``).
"""

from __future__ import annotations

import torch

from ..models.geometry import (
    FLAG_CHECKER,
    FLAG_DIELECTRIC,
    FLAG_INVISIBLE_LIGHT,
    Materials,
)
from . import rng as rng_ops
from . import vecmath as vm

DIELECTRIC_EPS = 1e-4


def checker_colour(mat: Materials, point: torch.Tensor) -> torch.Tensor:
    """Base colour after the checker flag: odd parity of
    ``mod2(floor(p.xz), 2)`` swaps in the emission colour
    (RayTracing.shader:313-317)."""
    fx = torch.floor(point[..., 0])
    fz = torch.floor(point[..., 2])
    cx = fx - 2.0 * torch.floor(vm.div(fx, 2.0))
    cz = fz - 2.0 * torch.floor(vm.div(fz, 2.0))
    swap = (mat.flag == FLAG_CHECKER) & (cx != cz)
    return torch.where(swap[..., None], mat.emission_colour, mat.colour)


def _refract_dir(d, normal, ior, u_fresnel):
    """RTIOW dielectric direction for unit ``d`` against the outward
    ``normal``: Schlick reflect-or-refract, decided by ``u_fresnel``."""
    entering = vm.dot(d, normal) < 0.0
    n_eff = torch.where(entering[..., None], normal, -normal)
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_t = torch.clamp(-vm.dot(d, n_eff), max=1.0)
    sin_t = vm.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot_refract = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * vm.pow(1.0 - cos_t, 5.0)
    do_reflect = cannot_refract | (schlick > u_fresnel)

    r_perp = eta[..., None] * (d + cos_t[..., None] * n_eff)
    k = torch.clamp(1.0 - vm.dot(r_perp, r_perp), min=0.0)
    refracted = r_perp - vm.sqrt(k)[..., None] * n_eff
    reflected = vm.reflect(d, n_eff)
    return torch.where(do_reflect[..., None], reflected, refracted)


def scatter(state, d, point, normal, mat: Materials, fast_scatter: bool = False):
    """Outgoing ray of scattering lanes: 1 specular-lottery draw, then 6 for
    the unit vector (RayTracing.shader:325-330), or 2 with ``fast_scatter``
    (``rng.random_direction_fast``). Returns ``(state, new_origin, new_dir,
    is_specular)``; ``is_specular`` is the f32 lottery outcome used in the
    throughput lerp."""
    state, u_spec = rng_ops.random_value(state)
    is_specular = (mat.specular_probability >= u_spec).to(torch.float32)

    if fast_scatter:
        state, unit = rng_ops.random_direction_fast(state)
    else:
        state, unit = rng_ops.random_direction(state)
    diffuse_dir = vm.normalize(normal + unit)
    specular_dir = vm.reflect(d, normal)
    surface_dir = vm.normalize(
        vm.lerp(
            diffuse_dir,
            specular_dir,
            (mat.smoothness * is_specular)[..., None],
        )
    )

    is_dielectric = mat.flag == FLAG_DIELECTRIC
    glass_dir = _refract_dir(d, normal, mat.ior, u_spec)
    new_dir = torch.where(is_dielectric[..., None], glass_dir, surface_dir)
    new_origin = point + torch.where(
        is_dielectric[..., None], new_dir * DIELECTRIC_EPS, 0.0
    )
    # dielectrics are tinted by colour only (no specular lerp)
    is_specular = torch.where(is_dielectric, 0.0, is_specular)
    return state, new_origin, new_dir, is_specular


def passthrough_mask(mat: Materials, bounce_idx: int, did_hit):
    """Invisible-light camera-ray passthrough lanes
    (RayTracing.shader:318-322)."""
    return did_hit & (mat.flag == FLAG_INVISIBLE_LIGHT) & (bounce_idx == 0)
