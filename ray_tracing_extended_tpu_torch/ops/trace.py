"""The path-tracing bounce loop: a masked, fixed-shape rewrite of the
reference's per-thread loop (Trace, RayTracing.shader:300-352).

Mirrors ``ray_tracing_extended_tpu/ops/trace.py``. Every lane iterates
under an ``alive`` mask and its state (origin, direction, throughput, PCG
state) advances only where the mask allows; the PCG state advances only on
scattering lanes, so a finished lane's stream is frozen like a returned
HLSL thread's. The loop stops early once every lane is dead.

Per bounce, in reference order: closest hit; checker / invisible-light
flags; the specular-lottery scatter (7 draws); emission and throughput;
Russian roulette (1 draw, survive iff ``U < max(rgb)``, boost by ``1/p``);
on a miss, the environment light and death.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.geometry import Scene
from . import rng as rng_ops
from . import vecmath as vm
from .environment import environment_light
from .intersect import closest_hit_bruteforce
from .materials import checker_colour, passthrough_mask, scatter

# Invisible-light passthrough origin advance (RayTracing.shader:320).
PASSTHROUGH_EPS = 0.001


def dup_intersect(intersect_fn):
    """``intersect_fn`` under the profiling knob ``dup_intersect`` (the TPU
    kernel's, ``megakernel.py:2030-2043``; the CUDA kernel's
    ``kDupIntersect``): the closest hit a second time from the origin with
    ``x + 1e-30``, folded as ``t = fmin(t, t2 + 1e30)``, which changes no
    hit's distance; the first call's winner and hit record stay."""

    def fn(o, d, scene):
        hit = intersect_fn(o, d, scene)
        o2 = torch.cat([o[:, :1] + 1e-30, o[:, 1:]], dim=1)
        t2 = intersect_fn(o2, d, scene).t
        return dataclasses.replace(hit, t=torch.fmin(hit.t, t2 + 1e30))

    return fn


def fetch_again(scene: Scene, index, base):
    """``base`` (B, 3) under the profiling knob ``dup_fetch`` (the TPU
    kernel's, ``megakernel.py:1463-1469``; the CUDA kernel's ``kDupFetch``
    and its ``fetch_again``): the winner's rows (a sphere's centre and
    radius, or a triangle's vertex, edges, normal and vertex normals), its
    material index and the 14 values of its material, read a second time
    through the index ``where(index < -1, index + 1, index)`` and summed,
    folded into the red channel as ``fmin(r, |sum| + 1e30)``, which changes
    no colour (``fmin`` drops a NaN operand)."""
    i = torch.where(index < -1, index + 1, index)
    sph, tri = scene.spheres, scene.triangles
    s = sph.count
    is_sphere = i < s
    si = torch.clamp(i, max=s - 1)
    ti = torch.clamp(i - s, 0, tri.count - 1)
    sph_sum = sph.center[si].sum(-1) + sph.radius[si]
    tri_sum = sum(getattr(tri, f)[ti].sum(-1) for f in (
        "pos_a", "edge_ab", "edge_ac", "n", "normal_a", "normal_b",
        "normal_c"))
    mat = scene.materials.take(
        torch.where(is_sphere, sph.mat_idx[si], tri.mat_idx[ti]))
    total = torch.where(is_sphere, sph_sum, tri_sum) + sum(
        getattr(mat, f).to(torch.float32).reshape(i.shape[0], -1).sum(-1)
        for f in ("colour", "emission_colour", "specular_colour",
                  "emission_strength", "smoothness", "specular_probability",
                  "ior", "flag"))
    red = torch.fmin(base[:, :1], total.abs()[:, None] + 1e30)
    return torch.cat([red, base[:, 1:]], dim=1)


def trace_segment(
    state: torch.Tensor,
    o: torch.Tensor,
    d: torch.Tensor,
    incoming: torch.Tensor,
    colour: torch.Tensor,
    alive: torch.Tensor,
    bounce_idx,
    scene: Scene,
    intersect_fn=None,
    fast_scatter: bool = False,
    dup_fetch: bool = False,
):
    """One bounce of the loop for a batch of lanes: the closest hit of each
    ``alive`` lane and what follows from it.

    ``bounce_idx`` is the bounce index, an int or a (B,) tensor (lanes of
    the adaptive slot machine sit at different bounces). Returns ``(state,
    o, d, incoming, colour, continues)``: ``continues`` marks the lanes
    whose path goes on (an invisible-light passthrough, or a scatter that
    survived roulette); the bounce budget is the caller's. ``dup_fetch``
    sets the profiling knob of that name (``fetch_again``)."""
    if intersect_fn is None:
        intersect_fn = closest_hit_bruteforce
    # dead lanes are parked far away, pointing away from the scene (+x,
    # made on the device: no host-to-device copy a bounce)
    parked_dir = torch.zeros_like(d[:1])
    parked_dir[:, 0] = 1.0
    o_live = torch.where(alive[..., None], o, 1.0e9)
    d_live = torch.where(alive[..., None], d, parked_dir)
    hit = intersect_fn(o_live, d_live, scene)
    did_hit = hit.hit & alive
    mat = (scene.materials.take(hit.mat_idx) if hit.material is None
           else hit.material)

    base_colour = checker_colour(mat, hit.point)
    if dup_fetch:
        base_colour = fetch_again(scene, hit.index, base_colour)
    passthru = passthrough_mask(mat, bounce_idx, did_hit)
    scattering = did_hit & ~passthru

    new_state, new_o, new_d, is_spec = scatter(
        state, d, hit.point, hit.normal, mat, fast_scatter=fast_scatter
    )
    emitted = mat.emission_colour * mat.emission_strength[..., None]
    inc_hit = incoming + emitted * colour
    col_hit = colour * vm.lerp(
        base_colour, mat.specular_colour, is_spec[..., None]
    )
    # Russian roulette; the clamped 1/p only keeps dead lanes finite
    p = torch.amax(col_hit, dim=-1)
    new_state, u_rr = rng_ops.random_value(new_state)
    survive = u_rr < p
    col_boosted = col_hit * (1.0 / torch.clamp(p, min=1e-30))[..., None]

    missed = alive & ~hit.hit
    inc_miss = incoming + environment_light(d, scene.env) * colour

    sc3 = scattering[..., None]
    o = torch.where(
        passthru[..., None],
        hit.point + d * PASSTHROUGH_EPS,
        torch.where(sc3, new_o, o),
    )
    d = torch.where(sc3, new_d, d)
    incoming = torch.where(
        sc3, inc_hit, torch.where(missed[..., None], inc_miss, incoming)
    )
    colour = torch.where(sc3 & survive[..., None], col_boosted, colour)
    state = torch.where(scattering, new_state, state)
    return state, o, d, incoming, colour, passthru | (scattering & survive)


def trace(
    state: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    scene: Scene,
    max_bounce: int,
    intersect_fn=None,
    with_bounce_counts: bool = False,
    fast_scatter: bool = False,
    dup_fetch: bool = False,
):
    """Trace a batch of rays to completion.

    ``state`` (B,) PCG states; ``origin``/``direction`` (B, 3) with unit
    directions. Bounces run ``0..max_bounce`` inclusive. ``intersect_fn``
    ``(o, d, scene) -> HitRecord`` defaults to the brute-force scan;
    ``fast_scatter`` picks the 2-draw unit-vector sampler; ``dup_fetch``
    sets the profiling knob of that name (``trace_segment``).

    Returns ``(state, incoming_light (B, 3), segments (B,) int32)``: a
    segment is one scene intersection of a live lane. With
    ``with_bounce_counts`` a fourth element holds the (max_bounce + 1,)
    int32 live-lane counts per bounce index.
    """
    b = origin.shape[0]
    dev = origin.device
    incoming = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    colour = torch.ones((b, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    segments = torch.zeros((b,), dtype=torch.int32, device=dev)
    counts = torch.zeros((max_bounce + 1,), dtype=torch.int32, device=dev)
    o, d = origin, direction

    for bounce_idx in range(max_bounce + 1):
        if not bool(alive.any()):
            break
        segments = segments + alive.to(torch.int32)
        if with_bounce_counts:
            counts[bounce_idx] += alive.sum().to(torch.int32)
        state, o, d, incoming, colour, alive = trace_segment(
            state, o, d, incoming, colour, alive, bounce_idx, scene,
            intersect_fn=intersect_fn, fast_scatter=fast_scatter,
            dup_fetch=dup_fetch,
        )

    if with_bounce_counts:
        return state, incoming, segments, counts
    return state, incoming, segments
