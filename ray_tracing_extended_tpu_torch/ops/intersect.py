"""Ray-primitive intersection, brute force over (rays x primitives).

Mirrors ``ray_tracing_extended_tpu/ops/intersect.py``
(CalculateRayCollision, RayTracing.shader:256-297, with RaySphere :120-146
and RayTriangle :150-174), keeping its quirks: the nearest sphere root only,
no t epsilon, padding spheres (radius <= 0) never hit, a backface-culled
triangle test with ``det >= 1e-6``, boxes behind the ray pass, and the first
primitive wins an exact tie. The JAX package forms its dot products as f32
matrix products; here every (ray, primitive) dot is an elementwise
three-term sum, so TF32 can never enter.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.geometry import Materials, Scene, Spheres, Triangles
from . import vecmath as vm

INF = float("inf")

# Backface-cull / degeneracy threshold (RayTracing.shader:169).
DET_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Closest hit for a batch of rays (HitInfo, RayTracing.shader:100-107,
    with the material replaced by an index into the material table)."""

    hit: torch.Tensor  # (B,) bool
    t: torch.Tensor  # (B,) f32, +inf on a miss
    point: torch.Tensor  # (B, 3) f32
    normal: torch.Tensor  # (B, 3) f32
    mat_idx: torch.Tensor  # (B,) int64, 0 on a miss
    # (B,) int64: the winner, a sphere's index below the scene's sphere
    # count and a triangle's from there on (the profiling knob dup_fetch
    # reads its rows again, ops/trace.py)
    index: torch.Tensor
    # the hit's material as its values, in place of ``mat_idx``'s row of
    # the scene's table (the profiling knobs stub_intersect and stub_fetch,
    # kernels/megakernel.py stub_intersector); None: ``mat_idx``'s row
    material: Materials | None = None


def _pair_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, 3) x (T, 3) -> (B, T) dot products, elementwise."""
    return (
        a[:, None, 0] * b[None, :, 0]
        + a[:, None, 1] * b[None, :, 1]
        + a[:, None, 2] * b[None, :, 2]
    )


def ray_spheres_t(o, d, spheres: Spheres) -> torch.Tensor:
    """Hit distances for all (ray, sphere) pairs, (B, S), +inf on a miss.

    Same expanded quadratic as the JAX package:
    ``b = dot(o, d) - dot(d, c)``, ``cc = |o|^2 - 2 dot(o, c) + (|c|^2 - r^2)``.
    """
    c = spheres.center
    r = spheres.radius
    b = vm.dot(o, d)[:, None] - _pair_dots(d, c)
    cc = (
        vm.dot(o, o)[:, None]
        - 2.0 * _pair_dots(o, c)
        + (vm.dot(c, c) - r * r)[None, :]
    )
    disc = b * b - cc
    t = -b - vm.sqrt(torch.clamp(disc, min=0.0))
    valid = (disc >= 0.0) & (t >= 0.0) & (r > 0.0)[None, :]
    return torch.where(valid, t, INF)


def ray_triangles_t(o, d, tris: Triangles) -> torch.Tensor:
    """Hit distances for all (ray, triangle) pairs, (B, T), +inf on a miss
    (backface-culled Moller-Trumbore on the precomputed constants)."""
    co = vm.cross(o, d)
    det = -_pair_dots(d, tris.n)
    t_det = _pair_dots(o, tris.n) - tris.n_dot_a[None, :]
    u_det = _pair_dots(co, tris.edge_ac) - _pair_dots(d, tris.cross_eac_a)
    v_det = -_pair_dots(co, tris.edge_ab) + _pair_dots(d, tris.cross_eab_a)
    w_det = det - u_det - v_det
    hit = (
        (det >= DET_EPS)
        & (t_det >= 0.0)
        & (u_det >= 0.0)
        & (v_det >= 0.0)
        & (w_det >= 0.0)
    )
    t = t_det / torch.where(det >= DET_EPS, det, torch.ones_like(det))
    return torch.where(hit, t, INF)


def ray_aabb(o, d, bounds_min, bounds_max) -> torch.Tensor:
    """Slab test for all (ray, box) pairs -> (B, C) bool; passes iff
    tNear <= tFar, with no tFar >= 0 requirement (RayBoundingBox,
    RayTracing.shader:177-187)."""
    inv_d = 1.0 / d
    t0 = (bounds_min[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bounds_max[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_near <= t_far


def _triangle_normal_at(o, d, tris: Triangles, idx) -> torch.Tensor:
    """Interpolated shading normal of one gathered triangle per ray
    (RayTracing.shader:161-171)."""
    pa = tris.pos_a[idx]
    e_ab = tris.edge_ab[idx]
    e_ac = tris.edge_ac[idx]
    n = tris.n[idx]
    ao = o - pa
    dao = vm.cross(ao, d)
    det = -vm.dot(d, n)
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    u = vm.dot(e_ac, dao) * inv_det
    v = -vm.dot(e_ab, dao) * inv_det
    w = 1.0 - u - v
    raw = (
        tris.normal_a[idx] * w[:, None]
        + tris.normal_b[idx] * u[:, None]
        + tris.normal_c[idx] * v[:, None]
    )
    return vm.normalize(raw)


def closest_hit_bruteforce(o, d, scene: Scene) -> HitRecord:
    """Closest hit over every sphere, then every triangle; a strictly closer
    hit wins and the first primitive wins an exact tie (argmin's first
    occurrence, like the shader's ``dst < closestHit.dst`` scan)."""
    t_all = torch.cat(
        [
            ray_spheres_t(o, d, scene.spheres),
            ray_triangles_t(o, d, scene.triangles),
        ],
        dim=1,
    )
    t, best = torch.min(t_all, dim=1)
    return hit_record(o, d, scene, t, best)


def hit_record(o, d, scene: Scene, t, best) -> HitRecord:
    """The hit record of each ray's winner: ``t`` (B,) its distance, +inf on
    a miss, ``best`` (B,) its index, a sphere's below the scene's sphere
    count and a triangle's from there on."""
    s = scene.spheres.count
    hit = torch.isfinite(t)
    point = o + d * torch.where(hit, t, 0.0)[:, None]

    is_sphere = best < s
    sph_idx = torch.clamp(best, max=s - 1)
    tri_idx = torch.clamp(best - s, 0, scene.triangles.count - 1)

    n_sph = vm.normalize(point - scene.spheres.center[sph_idx])
    n_tri = _triangle_normal_at(o, d, scene.triangles, tri_idx)
    normal = torch.where(is_sphere[:, None], n_sph, n_tri)

    mat_idx = torch.where(
        is_sphere,
        scene.spheres.mat_idx[sph_idx],
        scene.triangles.mat_idx[tri_idx],
    ).long()
    mat_idx = torch.where(hit, mat_idx, 0)
    return HitRecord(hit=hit, t=t, point=point, normal=normal, mat_idx=mat_idx,
                     index=best)
