"""The port's per-module functions against their JAX counterparts:
intersection, environment, materials and scatter, accumulation, tonemap,
and the scene presets; and the clustered closest hit (the CUDA kernel's
plain version) against the brute-force one.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances are stated where each is used; the reason is always the same:
XLA and PyTorch round transcendentals (and may order or fuse sums)
differently, by about an ulp.
"""

import dataclasses
import pathlib

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
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.ops import accumulate as tacc
from ray_tracing_extended_tpu_torch.ops import camera as tcam
from ray_tracing_extended_tpu_torch.ops import environment as tenv
from ray_tracing_extended_tpu_torch.ops import intersect as tint
from ray_tracing_extended_tpu_torch.ops import materials as tmat
from ray_tracing_extended_tpu_torch.ops import rng as trng
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


# ---- the clustered closest hit against the brute-force one ----

SCENES = pathlib.Path(rtt.__file__).resolve().parent.parent / "scenes"


def _clustered_scene(name):
    if name == "rtiow":
        return tpresets.rtiow_final_scene(width=96, height=54, device="cpu")
    if name == "cornell":
        return tpresets.cornell_box_scene(width=64, height=64, device="cpu")
    return rtt.load_json_scene(SCENES / "chess.json", device="cpu")


def _boxes(scene, tab):
    """Every box the clustered scan tests: (lo (K, 3), hi (K, 3))."""
    rows = [tab.clusters] + [t for t in (tab.chunks, tab.supers)
                             if t is not None]
    rows = torch.cat(rows).numpy()
    rows = rows[np.isfinite(rows[:, :3]).all(axis=1)]
    return rows[:, 0:3], rows[:, 4:7]


def _test_rays(kind, scene, cam, cfg, tab, n=1024):
    """``n`` seeded rays of one kind -> (o, d) f32 tensors."""
    rs = np.random.RandomState(12)
    lo, hi = _boxes(scene, tab)
    if kind == "camera":
        # a band of rows through the middle of the image
        pix = (cfg.height // 2 - 2) * cfg.width + torch.arange(n) * 3 % (
            4 * cfg.width)
        fp = tcam.focus_points(cam, pix % cfg.width, pix // cfg.width,
                               cfg.width, cfg.height)
        _, o, d = tcam.generate_rays(trng.seed(pix, 3), cam, fp, cfg.width)
        return o, d
    # the scene without a huge ground sphere's box
    small = (hi - lo).max(axis=1) < 100.0
    s_lo, s_hi = lo[small].min(axis=0), hi[small].max(axis=0)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if kind == "inside":
        o = rs.uniform(s_lo, s_hi, (n, 3)).astype(np.float32)
    elif kind == "outside":
        # from a shell around the scene, aimed at a point inside it
        mid, ext = (s_lo + s_hi) / 2, (s_hi - s_lo).max()
        o = (mid + 1.5 * ext * d).astype(np.float32)
        aim = rs.uniform(s_lo, s_hi, (n, 3))
        d = aim - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    elif kind == "axis":
        # one or two direction components exactly zero (some of them -0.0)
        o = rs.uniform(s_lo, s_hi, (n, 3)).astype(np.float32)
        zero = rs.rand(n, 3) < 0.5
        zero[zero.all(axis=1), 0] = False
        d = np.where(zero, np.where(rs.rand(n, 3) < 0.5, 0.0, -0.0), d)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    else:
        # origins on a face of a box of the scan, half of them with a zero
        # direction component on that axis (the slab's NaN case)
        k = rs.randint(0, lo.shape[0], n)
        o = rs.uniform(lo[k], hi[k]).astype(np.float32)
        axis = rs.randint(0, 3, n)
        face = np.where(rs.rand(n) < 0.5, lo[k, axis], hi[k, axis])
        o[np.arange(n), axis] = face
        flat = rs.rand(n) < 0.5
        d[np.arange(n)[flat], axis[flat]] = 0.0
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _bruteforce_winner(o, d, scene):
    t_all = torch.cat([tint.ray_spheres_t(o, d, scene.spheres),
                       tint.ray_triangles_t(o, d, scene.triangles)], dim=1)
    return torch.min(t_all, dim=1)


@pytest.mark.parametrize("kind", ["camera", "inside", "outside", "axis",
                                  "face"])
@pytest.mark.parametrize("name", ["rtiow", "cornell", "chess"])
def test_clustered_hit_matches_bruteforce(name, kind):
    """The culls change no winner: the same index and the same t, bit for
    bit, on at least 99.9% of the rays; on the rest the two winners' t
    differ by at most 1e-5 relative (a near-tie that rounding puts on the
    other side of a box's entry, the only cause the culls allow)."""
    scene, cam, cfg = _clustered_scene(name)
    tab = tmk.geometry_tables(scene, tmk.geometry(scene, cfg))
    o, d = _test_rays(kind, scene, cam, cfg, tab)
    t_b, i_b = _bruteforce_winner(o, d, scene)
    counts = {}
    t_c, i_c = tmk.clustered_winner(o, d, scene, tab, counts)
    assert int(torch.isfinite(t_b).sum()) > 100  # the rays really hit
    same = (i_b == i_c) & (t_b.view(torch.int32) == t_c.view(torch.int32))
    miss = ~torch.isfinite(t_b) & ~torch.isfinite(t_c)
    same |= miss
    assert float(same.double().mean()) >= 0.999, int((~same).sum())
    rest = ~same
    rel = (t_b[rest] - t_c[rest]).abs() / t_b[rest].abs().clamp_min(1e-30)
    assert bool((rel <= 1e-5).all()), (
        "rays whose winner moved by more than a near-tie",
        list(zip(i_b[rest].tolist(), i_c[rest].tolist(), t_b[rest].tolist(),
                 t_c[rest].tolist())))
    # no padding slot is tested, and the culls do cull
    n_real = int((scene.spheres.radius > 0).sum())
    assert counts["segments"] == o.shape[0]
    assert counts["sphere_tests"] <= n_real * o.shape[0]
    if name == "rtiow":
        assert counts["sphere_tests"] < 0.5 * n_real * o.shape[0]
    if name != "rtiow" and kind != "face":
        # (ray_aabb rejects a box on a NaN slab, the kernel's gate does not)
        line = tint.ray_aabb(o, d, scene.chunks.bounds_min,
                             scene.chunks.bounds_max)
        by_line = int((line.to(torch.int64)
                       @ scene.chunks.num_tris.to(torch.int64)).sum())
        assert 0 < counts["triangle_tests"] <= by_line


def _visits_one_by_one(t_near, t_far, nearest, best0, outer=None):
    """``_gated_visits`` as the kernel runs it: a loop over the boxes of one
    ray at a time."""
    t_near, t_far, nearest = (x.tolist() for x in (t_near, t_far, nearest))
    n_rays, n = len(t_near), len(t_near[0])
    visit = np.zeros((n_rays, n), bool)
    entered = None
    if outer is not None:
        o_near, o_far = outer[0].tolist(), outer[1].tolist()
        starts = outer[2].tolist()
        run_of = np.searchsorted(starts, np.arange(n), side="right") - 1
        entered = np.zeros((n_rays, len(o_near[0])), bool)
    for r in range(n_rays):
        best = float(best0[r])
        for k in range(n):
            if outer is not None:
                run = run_of[k]
                if k == starts[run]:
                    entered[r, run] = (o_far[r][run] >= 0.0 and o_near[r][run]
                                       <= min(o_far[r][run], best))
                if not entered[r, run]:
                    continue
            if t_far[r][k] >= 0.0 and t_near[r][k] <= min(t_far[r][k], best):
                visit[r, k] = True
                best = min(best, nearest[r][k])
    return visit, entered


# The outer runs' first boxes: runs of 32, 32 and 6 boxes, the chunk scan's
# layout; and 32, 6 and 32, a sphere scan's short last run of clusters
# where a camera's visit order can put it
OUTER_STARTS = {True: [0, 32, 64], "short_run_inside": [0, 32, 38]}


@pytest.mark.parametrize("with_outer", [False, *OUTER_STARTS])
def test_gated_visits_match_a_loop_over_boxes(with_outer):
    """The plain version's gate without a loop over boxes against the loop
    the kernel runs, on random slab intervals: boxes behind the origin,
    empty intervals, boxes without a hit, and members that rounding puts
    before their box's entry (the rays that take the loop); with outer
    boxes over the runs of ``OUTER_STARTS``."""
    rs = np.random.RandomState(13)
    n_rays, n = 300, 70
    starts = np.array(OUTER_STARTS.get(with_outer, [0]))
    t_near = rs.uniform(-2.0, 6.0, (n_rays, n)).astype(np.float32)
    t_far = (t_near + rs.uniform(-0.5, 3.0, (n_rays, n))).astype(np.float32)
    inside = rs.uniform(0.0, 1.0, (n_rays, n)).astype(np.float32)
    nearest = np.maximum(t_near, 0.0) + inside * np.abs(t_far - t_near)
    nearest[rs.rand(n_rays, n) < 0.6] = np.inf
    # a member just before its box's entry, on a tenth of the rays
    early = (rs.rand(n_rays, n) < 0.02) & (rs.rand(n_rays, 1) < 0.1)
    nearest = np.where(early, t_near - 1e-3, nearest).astype(np.float32)
    best0 = np.where(rs.rand(n_rays) < 0.5, np.inf,
                     rs.uniform(0.0, 6.0, n_rays)).astype(np.float32)
    outer = None
    if with_outer:
        o_near = np.minimum.reduceat(t_near, starts, axis=1)
        o_far = np.maximum.reduceat(t_far, starts, axis=1)
        # some runs culled whole
        o_far[rs.rand(n_rays, len(starts)) < 0.2] = -1.0
        outer = (torch.from_numpy(o_near), torch.from_numpy(o_far),
                 torch.from_numpy(starts))
    args = [torch.from_numpy(x) for x in (t_near, t_far, nearest, best0)]
    visit, entered = tmk._gated_visits(*args, outer)
    want, want_entered = _visits_one_by_one(*args, outer)
    assert np.array_equal(visit.numpy(), want)
    assert 0.05 < want.mean() < 0.95
    if with_outer:
        assert np.array_equal(entered.numpy(), want_entered)
        assert 0.05 < want_entered.mean() < 0.95
    else:
        assert entered is None


def test_lower_index_wins_a_tie():
    """Two equal spheres and two coplanar (equal) triangles: the one of
    lower scene index wins, whatever the clustered order, and a sphere keeps
    a tie with a triangle."""
    rs = np.random.RandomState(14)
    b = SceneBuilder()
    centres = rs.uniform(-3.0, 3.0, (40, 3)).astype(np.float32)
    for c in centres:
        b.add_sphere(c, 0.3, Material())
    for c in centres[:12]:  # spheres 40-51 repeat spheres 0-11
        b.add_sphere(c, 0.3, Material())
    # wound to face the rays (the test culls back faces)
    tri = np.array([[[-4.0, -4.0, 5.0], [0.0, 4.0, 5.0], [4.0, -4.0, 5.0]]],
                   np.float32)
    nrm = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (1, 3, 1))
    b.add_triangles(tri, nrm, Material())
    b.add_triangles(tri, nrm, Material())
    scene = b.build(device="cpu")
    cfg = rtt.RenderConfig(width=8, height=8)
    tab = tmk.geometry_tables(scene, tmk.geometry(scene, cfg))
    assert tab.geometry == "chunks" and tab.chunks.shape[0] == 2
    # at the repeated spheres from z = -10, and past them at the triangles
    o = np.concatenate([centres[:12] + rs.uniform(-0.2, 0.2, (12, 3)),
                        rs.uniform(-1.0, 1.0, (12, 3)) * [3.5, 3.5, 0.0]])
    o[:, 2] = -10.0
    o = torch.from_numpy(o.astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(24, 1)
    t_b, i_b = _bruteforce_winner(o, d, scene)
    t_c, i_c = tmk.clustered_winner(o, d, scene, tab)
    assert torch.equal(i_b, i_c) and torch.equal(t_b, t_c)
    s = scene.spheres.count
    t_sph = tint.ray_spheres_t(o, d, scene.spheres)
    twins = 0
    for r in torch.isfinite(t_c).nonzero().squeeze(1).tolist():
        w = int(i_c[r])
        if w < s:
            # its twin ties exactly and has the higher index
            if w < 12 and float(t_sph[r, w + 40]) == float(t_c[r]):
                twins += 1
            assert w < 40
        else:
            assert w == s  # the first of the two equal triangles
    assert twins >= 6 and int((i_c >= s).sum()) >= 3


@pytest.mark.parametrize("name", ["cornell", "chess"])
def test_bounded_chunk_gate_against_line_gate(name):
    """The t-bounded chunk gate on Cornell and on a band of Chess, camera
    rays and rays that start inside the scene (as bounces do): it enters no
    chunk the reference's line gate (``ray_aabb``) rejects, fewer of them,
    and every chunk that holds the ray's winner."""
    scene, cam, cfg = _clustered_scene(name)
    tab = tmk.geometry_tables(scene, "chunks")
    o, d = (torch.cat(x) for x in zip(
        _test_rays("camera", scene, cam, cfg, tab, n=384),
        _test_rays("inside", scene, cam, cfg, tab, n=384)))
    line = tint.ray_aabb(o, d, scene.chunks.bounds_min, scene.chunks.bounds_max)
    counts = {}
    t_c, i_c = tmk.clustered_winner(o, d, scene, tab, counts)
    tris = scene.chunks.num_tris.to(torch.int64)
    by_line = int((line.to(torch.int64) @ tris).sum())
    assert counts["triangle_tests"] < by_line
    if name == "chess":
        # 440 chunks in index order, not front to back: the bound culls
        # only what comes after a nearer hit in the table
        assert counts["triangle_tests"] < 0.8 * by_line
        assert tab.supers is not None
        assert counts["chunk_slabs"] < 440 * 768
    s = scene.spheres.count
    won = (i_c >= s).nonzero().squeeze(1)
    assert won.numel() > 100
    assert bool(line[won, tab.chunk_of[i_c[won] - s]].all())
    t_b, i_b = _bruteforce_winner(o, d, scene)
    assert torch.equal(i_b, i_c) and torch.equal(t_b, t_c)
