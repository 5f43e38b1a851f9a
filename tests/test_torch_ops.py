"""The port's per-module functions against their JAX counterparts:
intersection, environment, materials and scatter, accumulation, tonemap,
and the scene presets.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances are stated where each is used; the reason is always the same:
XLA and PyTorch round transcendentals (and may order or fuse sums)
differently, by about an ulp.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.models.geometry import Environment as JEnv
from ray_tracing_extended_tpu.ops import accumulate as jacc
from ray_tracing_extended_tpu.ops import environment as jenv
from ray_tracing_extended_tpu.ops import intersect as jint
from ray_tracing_extended_tpu.ops import materials as jmat
from ray_tracing_extended_tpu.ops import tonemap as jtone
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.ops import accumulate as tacc
from ray_tracing_extended_tpu_torch.ops import environment as tenv
from ray_tracing_extended_tpu_torch.ops import intersect as tint
from ray_tracing_extended_tpu_torch.ops import materials as tmat
from ray_tracing_extended_tpu_torch.ops import tonemap as ttone

EDGE = 1e-4  # pairs this close to a hit/miss boundary may flip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over (each small op then waits on its
    parallel region)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, lo, hi, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _check_flips(t_port, t_jax, near_edge):
    hit_p, hit_j = np.isfinite(t_port), np.isfinite(t_jax)
    flips = (hit_p != hit_j) & ~near_edge
    assert not flips.any(), f"{flips.sum()} hit/miss flips off the edges"
    both = hit_p & hit_j
    assert both.sum() > 100  # the rays really hit something
    return both


def test_sphere_t_matches():
    js, _, _ = jpresets.three_sphere_scene(width=8, height=8)
    ts = scene_from_arrays(js, device="cpu")
    o, d = _rays(2048, -2.5, 2.5, seed=0)
    t_j = np.asarray(jint.ray_spheres_t(jnp.asarray(o), jnp.asarray(d),
                                        js.spheres))
    t_p = tint.ray_spheres_t(torch.from_numpy(o), torch.from_numpy(d),
                             ts.spheres).numpy()
    # the discriminant and the root's sign, in float64, mark the edges
    c = np.asarray(js.spheres.center, np.float64)
    r = np.asarray(js.spheres.radius, np.float64)
    oc = o[:, None, :].astype(np.float64) - c[None]
    b = np.einsum("bsk,bk->bs", oc, d.astype(np.float64))
    disc = b * b - (np.einsum("bsk,bsk->bs", oc, oc) - r * r)
    t64 = -b - np.sqrt(np.maximum(disc, 0.0))
    near = (np.abs(disc) < EDGE * np.maximum(r * r, 1.0)) | (np.abs(t64) < EDGE)
    both = _check_flips(t_p, t_j, near)
    small = both & (r < 10.0)[None, :]
    np.testing.assert_allclose(t_p[small], t_j[small], rtol=1e-4, atol=1e-5)
    # On the ground sphere (r = 100) the expanded quadratic of both packages
    # cancels |c|^2 against r^2: its f32 error grows as
    # eps * (|o| + |c|)^2 / sqrt(disc) on grazing rays, and the two
    # packages round it differently. Hold both to the float64 root within
    # a few times that bound.
    o_norm = np.linalg.norm(o, axis=1)[:, None]
    c_norm = np.linalg.norm(c, axis=1)[None, :]
    bound = (4 * 2.0**-24 * ((o_norm + c_norm) ** 2 + r * r)
             / np.sqrt(np.maximum(disc, 1e-12)) + 1e-5 * (1.0 + np.abs(t64)))
    for t in (t_p, t_j):
        assert (np.abs(t - t64)[both] <= bound[both]).all()


def test_triangle_t_matches():
    js, _, _ = jpresets.cornell_box_scene(width=8, height=8)
    ts = scene_from_arrays(js, device="cpu")
    o, d = _rays(2048, -0.9, 0.9, seed=1)
    o[:, 2] += 1.0  # inside the box
    t_j = np.asarray(jint.ray_triangles_t(jnp.asarray(o), jnp.asarray(d),
                                          js.triangles))
    t_p = tint.ray_triangles_t(torch.from_numpy(o), torch.from_numpy(d),
                               ts.triangles).numpy()
    tri = js.triangles
    n = np.asarray(tri.n, np.float64)
    det = -(d.astype(np.float64) @ n.T)
    scale = np.maximum(np.abs(det), 1e-12)
    co = np.cross(o, d).astype(np.float64)
    dd = d.astype(np.float64)
    u = (co @ np.asarray(tri.edge_ac, np.float64).T
         - dd @ np.asarray(tri.cross_eac_a, np.float64).T) / scale
    v = (-(co @ np.asarray(tri.edge_ab, np.float64).T)
         + dd @ np.asarray(tri.cross_eab_a, np.float64).T) / scale
    t_det = o.astype(np.float64) @ n.T - np.asarray(tri.n_dot_a, np.float64)
    near = ((np.abs(det - 1e-6) < EDGE) | (np.abs(u) < EDGE)
            | (np.abs(v) < EDGE) | (np.abs(1.0 - u - v) < EDGE)
            | (np.abs(t_det / scale) < EDGE))
    both = _check_flips(t_p, t_j, near)
    np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-5, atol=1e-5)


def test_closest_hit_matches():
    js, _, _ = jpresets.cornell_box_scene(width=8, height=8)
    ts = scene_from_arrays(js, device="cpu")
    o, d = _rays(1024, -0.5, 0.5, seed=2)
    o[:, 2] += 1.0
    hj = jint.closest_hit_bruteforce(jnp.asarray(o), jnp.asarray(d), js)
    hp = tint.closest_hit_bruteforce(torch.from_numpy(o), torch.from_numpy(d),
                                     ts)
    same = hp.mat_idx.numpy() == np.asarray(hj.mat_idx)
    assert same.mean() > 0.995
    np.testing.assert_array_equal(hp.hit.numpy(), np.asarray(hj.hit))
    np.testing.assert_allclose(hp.point.numpy()[same],
                               np.asarray(hj.point)[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(hp.normal.numpy()[same],
                               np.asarray(hj.normal)[same], rtol=0, atol=1e-5)


def test_ray_aabb_matches():
    o, d = _rays(512, -2.0, 2.0, seed=3)
    rs = np.random.RandomState(4)
    lo = rs.uniform(-1.5, 1.0, (64, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    want = np.asarray(jint.ray_aabb(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(lo), jnp.asarray(hi)))
    got = tint.ray_aabb(*map(torch.from_numpy, (o, d, lo, hi))).numpy()
    assert (got == want).mean() > 0.999


def _sun_env():
    sun = np.array([0.3, 0.8, -0.5], np.float32)
    return JEnv(
        enabled=np.float32(1.0),
        ground_colour=np.array([0.35, 0.3, 0.35], np.float32),
        sky_colour_horizon=np.array([1.0, 1.0, 1.0], np.float32),
        sky_colour_zenith=np.array([0.08, 0.36, 0.72], np.float32),
        sun_focus=np.float32(50.0),
        sun_intensity=np.float32(5.0),
        sun_dir=sun / np.linalg.norm(sun),
    )


@pytest.mark.parametrize("which", ["gradient_sky", "sun", "disabled"])
def test_environment_matches(which):
    if which == "gradient_sky":
        env = jpresets.rtiow_final_scene(width=8, height=8)[0].env
    elif which == "sun":
        env = _sun_env()
    else:
        env = JEnv.disabled()
    t_env = scene_from_arrays(
        dataclasses.replace(jpresets.three_sphere_scene(width=8, height=8)[0],
                            env=env),
        device="cpu",
    ).env
    _, d = _rays(4096, 0, 1, seed=5)
    want = np.asarray(jenv.environment_light(jnp.asarray(d), env))
    got = tenv.environment_light(torch.from_numpy(d), t_env).numpy()
    # pow() of a value near 1 by 50 magnifies an ulp of its base
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_checker_colour_matches():
    js, _, _ = jpresets.three_sphere_scene(width=8, height=8)
    rs = np.random.RandomState(6)
    # one checker material, swapping to a distinct emission colour
    mats = dataclasses.replace(
        js.materials,
        flag=jnp.asarray(np.array([1, 0, 3, 0], np.int32)),
        emission_colour=jnp.asarray(rs.rand(4, 3).astype(np.float32)),
    )
    idx = rs.randint(0, 4, 2048)
    point = rs.uniform(-5, 5, (2048, 3)).astype(np.float32)
    tm = scene_from_arrays(dataclasses.replace(js, materials=mats),
                           device="cpu").materials
    want = np.asarray(jmat.checker_colour(mats.take(jnp.asarray(idx)),
                                          jnp.asarray(point)))
    got = tmat.checker_colour(tm.take(torch.from_numpy(idx)),
                              torch.from_numpy(point)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scatter_matches():
    js, _, _ = jpresets.rtiow_final_scene(width=8, height=8)
    ts = scene_from_arrays(js, device="cpu")
    n_real = int((np.asarray(js.spheres.radius) > 0).sum())
    rs = np.random.RandomState(7)
    b = 4096
    idx = rs.randint(0, n_real, b)
    state = rs.randint(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    _, d = _rays(b, 0, 1, seed=8)
    _, normal = _rays(b, 0, 1, seed=9)
    point = rs.uniform(-3, 3, (b, 3)).astype(np.float32)
    jm = js.materials.take(jnp.asarray(np.asarray(js.spheres.mat_idx)[idx]))
    tm = ts.materials.take(ts.spheres.mat_idx[torch.from_numpy(idx)])
    js_, jo, jd, jspec = jmat.scatter(jnp.asarray(state), jnp.asarray(d),
                                      jnp.asarray(point),
                                      jnp.asarray(normal), jm)
    ts_, to, td, tspec = tmat.scatter(
        torch.from_numpy(state.astype(np.int64)), torch.from_numpy(d),
        torch.from_numpy(point), torch.from_numpy(normal), tm,
    )
    # 7 draws, exactly; the lottery outcome is exact (it compares a draw)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tspec.numpy(), np.asarray(jspec))
    # directions agree to an ulp-level tolerance; a dielectric whose
    # Fresnel test sits on an ulp may pick the other branch
    close = (np.abs(td.numpy() - np.asarray(jd)).max(-1) < 1e-5) & (
        np.abs(to.numpy() - np.asarray(jo)).max(-1) < 1e-5)
    assert close.mean() > 0.999, close.mean()
    assert (np.asarray(jm.flag) == 3).sum() > 50  # glass was exercised


@pytest.mark.parametrize("clamp", [True, False])
def test_accumulate_matches(clamp):
    rs = np.random.RandomState(10)
    prev = rs.uniform(-0.5, 2.0, (16, 24, 3)).astype(np.float32)
    cur = rs.uniform(-0.5, 2.0, (16, 24, 3)).astype(np.float32)
    for frame in (0, 1, 7, 1000):
        want = np.asarray(jacc.accumulate(jnp.asarray(prev), jnp.asarray(cur),
                                          jnp.uint32(frame), clamp=clamp))
        got = tacc.accumulate(torch.from_numpy(prev), torch.from_numpy(cur),
                              frame, clamp=clamp).numpy()
        # one rounding of the multiply-add apart at most (XLA may fuse it)
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)
        if frame == 0:
            np.testing.assert_array_equal(
                got, np.clip(cur, 0, 1) if clamp else cur)


@pytest.mark.parametrize("tone", ["none", "reinhard", "aces"])
def test_tonemap_matches(tone):
    img = np.random.RandomState(11).uniform(0, 3, (32, 32, 3)).astype(np.float32)
    want = np.asarray(jtone.to_srgb8(jnp.asarray(img), tone=tone))
    got = ttone.to_srgb8(torch.from_numpy(img), tone=tone).numpy()
    # an ulp of pow() may move a value across a rounding step of 1/255
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got == want).mean() > 0.999


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        elif v is not None and not isinstance(v, bool):
            yield f"{prefix}{f.name}", v


@pytest.mark.parametrize(
    "name", ["three_sphere_scene", "rtiow_final_scene", "cornell_box_scene"]
)
def test_presets_identical(name):
    j_scene, j_cam, j_cfg = getattr(jpresets, name)(width=40, height=30)
    t_scene, t_cam, t_cfg = getattr(tpresets, name)(width=40, height=30,
                                                    device="cpu")
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    t_leaves = dict(_leaves(t_scene))
    j_leaves = {
        k: v for k, v in _leaves(j_scene)
        if not k.startswith(("tri_bvh", "sphere_bvh", "packed"))
    }
    assert set(t_leaves) == set(j_leaves)
    for k, v in j_leaves.items():
        assert np.array_equal(t_leaves[k].numpy(), np.asarray(v)), k
        assert t_leaves[k].numpy().dtype == np.asarray(v).dtype, k
    for k, v in _leaves(camera_from_arrays(j_cam, device="cpu")):
        assert np.array_equal(getattr(t_cam, k).numpy(), v.numpy()), k
    assert t_scene.has_triangles == (name == "cornell_box_scene")
    assert (scene_from_arrays(j_scene, device="cpu").has_triangles
            == t_scene.has_triangles)
