"""The sphere scan's two-level cull and its per-camera visit order.

Past ``SUPER_CLUSTERS`` clusters the sphere tables carry one super box over
each run of 32 clusters in table order (``sphere_tables``), and a launch
takes the clusters, and the supers, nearest box first from its camera
(``front_to_back``, ``visit_tables``). On the CPU: the super boxes, the
order against the JAX package's rule (``megakernel.py:2512-2533``, evaluated
here with ``jnp``), the ordered two-level scan against the flat table-order
one on rays of the 14,401-sphere scene, and the order's cache. On the card
(marker ``cuda``, skipped without one): the kernel against its plain version
bit for bit on both wide scenes, and on a scene with supers that fits a
block's shared memory on both table routes:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sphere_supers.py -q
    python -m pytest tests/test_torch_sphere_supers.py -m cuda --noconftest -q
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu_torch.ops import camera as tcam
from ray_tracing_extended_tpu_torch.ops import rng as trng
from ray_tracing_extended_tpu_torch.ops.trace import trace_segment

from ray_tracing_extended_tpu_torch.models.wide_scenes import (
    HALF_100K,
    HALF_PAST_LIMIT,
    rtiow_camera_and_config,
    wide_sphere_builder,
    wide_sphere_scene,
)

SUPER = mk.SUPER_CLUSTERS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (the suite runs several
    workers on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wide():
    """The 14,401-sphere scene at 32x18, 2 bounces, on the CPU."""
    return wide_sphere_scene(tpresets, HALF_PAST_LIMIT, width=32, height=18,
                             max_bounce=2, spp=1, device="cpu")


def _bits(rows, c):
    return rows[:, c].contiguous().view(torch.int32)


def _grid_scene(n, device="cpu"):
    """``n`` equal spheres on a jittered grid (none hoisted): ``n / 32``
    clusters, rounded up."""
    rs = np.random.RandomState(n)
    b = SceneBuilder(env=tpresets._gradient_sky())
    side = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        c = (i % side + 0.3 * rs.rand(), 0.3 * rs.rand(), i // side)
        b.add_sphere(c, 0.2, Material.lambertian((0.5, 0.5, 0.5)))
    return b.build(device=device)


@pytest.mark.parametrize("n, runs", [(1024, None), (1025, [32, 1])])
def test_no_super_at_32_clusters_or_fewer(n, runs):
    """Supers only past 32 clusters: 1,024 spheres make 32 clusters and
    none, 1,025 make 33 and two runs of 32 and 1."""
    tab = mk.geometry_tables(_grid_scene(n), "spheres")
    assert tab.n_hoist == 0
    assert tab.clusters.shape[0] == -(-n // 32)
    if runs is None:
        assert tab.sph_supers is None
    else:
        assert _bits(tab.sph_supers, 7).tolist() == runs
    # RTIOW: 15 clusters, no super
    scene = tpresets.rtiow_final_scene(device="cpu")[0]
    assert mk.geometry_tables(scene, "spheres").sph_supers is None


@pytest.mark.parametrize("half", [HALF_PAST_LIMIT, HALF_100K])
def test_super_boxes_hold_their_clusters(half):
    """One super a run of 32 clusters in table order, the last run the
    rest: every cluster in exactly one super, each super's box the union of
    its clusters' boxes (so it holds them), the hoist kept."""
    scene = wide_sphere_scene(tpresets, half, device="cpu")[0]
    tab = mk.geometry_tables(scene, "spheres")
    k = tab.clusters.shape[0]
    su = tab.sph_supers
    assert tab.n_hoist == 4 and k > SUPER
    assert su.shape[0] == -(-k // SUPER)
    first, count = _bits(su, 3), _bits(su, 7)
    assert torch.equal(first, torch.arange(0, k, SUPER, dtype=torch.int32))
    assert int(count.sum()) == k and bool((count[:-1] == SUPER).all())
    for r in range(su.shape[0]):
        run = tab.clusters[int(first[r]):int(first[r]) + int(count[r])]
        assert torch.equal(su[r, 0:3], run[:, 0:3].amin(0))
        assert torch.equal(su[r, 4:7], run[:, 4:7].amax(0))


def _add_quad(b):
    """Two triangles facing +z (RTIOW's camera sees their front) on the
    builder ``b``."""
    quad = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                     [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    b.add_triangles(quad, np.tile(np.float32([0, 0, 1]), (2, 3, 1)),
                    Material.lambertian((0.5, 0.5, 0.5)))
    return b


# a scene with triangles takes the chunk scan, or with a triangle BVH the
# traversal: ``build_bvh`` of ``SceneBuilder.build``, and the geometry
TRIANGLE_GEOMETRIES = [(None, "chunks"), ("tri", "bvh")]


def test_triangle_geometries_scan_clusters_in_one_level():
    """The wide spheres beside a quad (chunk scan, or a triangle BVH): the
    triangle geometries' tables carry no supers (their kernels scan the
    clusters in one level), in the camera's order all the same; the sphere
    geometry's tables of the same spheres carry them."""
    cam, cfg = rtiow_camera_and_config(tpresets, device="cpu")
    b = wide_sphere_builder(tpresets, HALF_PAST_LIMIT)
    assert mk.geometry_tables(b.build(device="cpu"),
                              "spheres").sph_supers is not None
    _add_quad(b)
    for build_bvh, geom in TRIANGLE_GEOMETRIES:
        scene = b.build(build_bvh=build_bvh, device="cpu")
        assert mk.geometry(scene, cfg) == geom
        tab = mk.visit_tables(scene, geom, cam)
        assert tab.sph_supers is None and tab.clusters.shape[0] == 450
        order = mk.front_to_back(mk.geometry_tables(scene, "spheres"),
                                 cam.position)
        assert tab.cluster_order.tolist() != order["cluster_order"].tolist()


def _tpu_order(lo, hi, position, n_supers, sup_lo=None, sup_hi=None):
    """The JAX package's visit order (``megakernel.py:2512-2533``, ``:2568``)
    in ``jnp``: with supers, ``_f2b`` of the super boxes, then the clusters
    of each super by ``_f2b_within`` (the last run padded with
    ``pack._supers``' inverted boxes, which sort last and are dropped); else
    ``_f2b`` of the clusters. -> (the clusters' visit order, the supers')."""
    import jax.numpy as jnp

    p = jnp.asarray(position)

    def _boxdist2(bounds):
        q = jnp.clip(p[None, :], bounds[:, 0:3], bounds[:, 3:6])
        return jnp.sum((q - p[None, :]) ** 2, axis=1)

    def _f2b(bounds):
        return np.array(jnp.argsort(_boxdist2(bounds)).astype(jnp.int32))

    def _f2b_within(bounds, n_sup):
        d2 = _boxdist2(bounds)
        idx = jnp.argsort(d2.reshape(n_sup, SUPER), axis=1).astype(jnp.int32)
        base = (jnp.arange(n_sup, dtype=jnp.int32) * SUPER)[:, None]
        return np.array((idx + base).reshape(-1))

    k = lo.shape[0]
    bounds = np.concatenate([lo, hi], axis=1).astype(np.float32)
    if not n_supers:
        return _f2b(jnp.asarray(bounds)), None
    pad = np.zeros((n_supers * SUPER - k, 6), np.float32)
    pad[:, :3], pad[:, 3:] = 1e30, -1e30
    sperm = _f2b_within(jnp.asarray(np.concatenate([bounds, pad])), n_supers)
    sperm_sup = _f2b(jnp.asarray(np.concatenate([sup_lo, sup_hi], axis=1)))
    seq = [int(c) for s in sperm_sup for c in sperm[s * SUPER:(s + 1) * SUPER]
           if c < k]
    return np.array(seq), sperm_sup


def _positions(scene):
    """The scene's camera position, one inside the grid of spheres and two
    seeded ones around it."""
    rs = np.random.RandomState(21)
    return [np.float32([13.0, 2.0, 3.0]), np.float32([0.3, 0.25, -0.7])] + [
        rs.uniform(-70.0, 70.0, 3).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("case", ["wide", "random", "rtiow"])
def test_launch_order_is_the_tpu_rule(case):
    """``front_to_back`` against the JAX package's rule on the same boxes
    and positions: the gathered cluster rows, the supers' order, and each
    super row's first gathered cluster and count."""
    if case == "wide":
        scene = wide_sphere_scene(tpresets, HALF_PAST_LIMIT, device="cpu")[0]
    elif case == "random":
        rs = np.random.RandomState(22)
        b = SceneBuilder(env=tpresets._gradient_sky())
        for c, r in zip(rs.uniform(-20.0, 20.0, (3000, 3)),
                        rs.uniform(0.05, 0.6, 3000)):
            b.add_sphere(tuple(c), float(r), Material.lambertian((0.5,) * 3))
        scene = b.build(device="cpu")
    else:
        scene = tpresets.rtiow_final_scene(device="cpu")[0]
    tab = mk.geometry_tables(scene, "spheres")
    cl, su = tab.clusters.numpy(), tab.sph_supers
    n_sup = 0 if su is None else su.shape[0]
    assert (n_sup > 1) == (case != "rtiow")
    for pos in _positions(scene):
        got = mk.front_to_back(tab, torch.from_numpy(pos))
        want, want_sup = _tpu_order(
            cl[:, 0:3], cl[:, 4:7], pos, n_sup,
            *((None, None) if su is None else (su[:, 0:3].numpy(),
                                               su[:, 4:7].numpy())))
        assert got["cluster_order"].tolist() == want.tolist()
        assert torch.equal(got["clusters"], tab.clusters[want])
        if su is None:
            assert "sph_supers" not in got
            continue
        rows = got["sph_supers"]
        assert torch.equal(rows[:, [0, 1, 2, 4, 5, 6, 7]],
                           su[want_sup][:, [0, 1, 2, 4, 5, 6, 7]])
        # each super row names its run in the gathered clusters
        count = _bits(rows, 7)
        assert torch.equal(_bits(rows, 3), torch.cumsum(count, 0) - count)
        for r, s in enumerate(want_sup.tolist()):
            run = got["cluster_order"][int(_bits(rows, 3)[r]):][:int(count[r])]
            assert bool((run // SUPER == s).all())


def _rays(scene, cam, cfg):
    """Every pixel's camera ray of the frame, and the rays of its first
    bounce (the lanes whose path goes on), by the flat scan."""
    n = cfg.width * cfg.height
    pix = torch.arange(n)
    fp = tcam.focus_points(cam, pix % cfg.width, pix // cfg.width, cfg.width,
                           cfg.height)
    state, o, d = tcam.generate_rays(trng.seed(pix, 3), cam, fp, cfg.width)
    flat = dataclasses.replace(mk.geometry_tables(scene, "spheres"),
                               sph_supers=None)
    zero = torch.zeros((n, 3))
    _, o1, d1, _, _, goes_on = trace_segment(
        state, o, d, zero, torch.ones((n, 3)), torch.ones(n, dtype=torch.bool),
        0, scene, intersect_fn=functools.partial(mk.closest_hit_clustered,
                                                 tables=flat))
    return {"camera": (o, d), "bounce": (o1[goes_on], d1[goes_on])}


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_ordered_two_level_scan_matches_flat_scan(wide, kind):
    """On the rays of a 32x18 frame of the 14,401-sphere scene, the ordered
    two-level scan's winner is the flat table-order scan's, (t, index) bit
    for bit; a ray may differ only as a near-tie (both t within 1e-6
    relative). The two levels test under 0.3 x 450 boxes a segment."""
    scene, cam, cfg = wide
    o, d = _rays(scene, cam, cfg)[kind]
    assert o.shape[0] > 200
    tab = mk.geometry_tables(scene, "spheres")
    assert tab.clusters.shape[0] == 450 and tab.sph_supers.shape[0] == 15
    flat = dataclasses.replace(tab, sph_supers=None)
    counts, flat_counts = {}, {}
    t_f, i_f = mk.clustered_winner(o, d, scene, flat, flat_counts)
    t_o, i_o = mk.clustered_winner(
        o, d, scene, mk.visit_tables(scene, "spheres", cam), counts)
    assert int(torch.isfinite(t_f).sum()) > 100
    same = (i_f == i_o) & (t_f.view(torch.int32) == t_o.view(torch.int32))
    rest = ~same
    rel = (t_f[rest] - t_o[rest]).abs() / t_f[rest].abs()
    assert float(same.double().mean()) > 0.99
    assert bool((rel <= 1e-6).all()), (t_f[rest], t_o[rest])
    n = counts["segments"]
    assert n == flat_counts["segments"] == o.shape[0]
    assert flat_counts["cluster_slabs"] == 450 * n
    assert counts["cluster_slabs"] < 0.3 * 450 * n, counts["cluster_slabs"] / n
    assert counts["super_slabs"] == 15 * n
    assert counts["sphere_tests"] <= 1.05 * flat_counts["sphere_tests"]


def test_still_camera_pays_for_its_order_once(wide):
    """``visit_tables`` finds a camera's order again while its position is
    the same tensor, unwritten; a moved camera gets its own order, and a
    scene whose tensors change builds its tables and order anew."""
    scene, cam, cfg = wide
    a = mk.visit_tables(scene, "spheres", cam)
    assert mk.visit_tables(scene, "spheres", cam) is a
    assert mk.visit_tables(scene, "spheres",
                           cam.replace(defocus_strength=0.0)) is a
    moved = cam.replace(position=cam.position + torch.tensor([0.0, 0.0, 40.0]))
    b = mk.visit_tables(scene, "spheres", moved)
    assert b is not a and not torch.equal(b.cluster_order, a.cluster_order)
    scene2 = wide_sphere_scene(tpresets, HALF_PAST_LIMIT, device="cpu")[0]
    pos = cam.position.clone()
    still = cam.replace(position=pos)
    c = mk.visit_tables(scene2, "spheres", still)
    pos += torch.tensor([0.0, 0.0, 40.0])  # written in place
    e = mk.visit_tables(scene2, "spheres", still)
    assert e is not c and torch.equal(e.cluster_order, b.cluster_order)
    # the launch's tables take the camera's order, the plain path the same
    tabs = mk.scene_tables(scene, cam, cfg)
    assert torch.equal(tabs.clusters, a.clusters) and tabs.params is not None
    fn = mk.plain_intersector(scene, cam, cfg)
    assert fn.keywords["tables"] is mk.visit_tables(scene, "spheres", cam)


def test_plain_frames_follow_the_camera_order(wide):
    """The plain path's default closest hit takes the camera's order: its
    frame equals one through ``plain_intersector`` with that camera, and
    the counts of a frame fall against the flat scan's by the cull."""
    scene, cam, cfg = wide
    counts = {}
    fn = mk.plain_intersector(scene, cam, cfg, counts)
    a = mk.render_frames_plain(scene, cam, cfg, 3, intersect_fn=fn)[0]
    assert torch.equal(a, rtt.render_frame(scene, cam, cfg, 3))
    per = counts["cluster_slabs"] / counts["segments"]
    assert per < 0.3 * 450, per


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _kernel_vs_plain(scene, cam, cfg, tables=None):
    """The kernel's frame against the plain version in the kernel's test
    forms, from the same camera order: image, segment map and histogram
    bit for bit."""
    k = mk.render_frames_mega(scene, cam, cfg, 5, collect_stats=True,
                              tables=tables)
    fn = mk.plain_intersector(scene, cam, cfg, direct=True)
    p = mk.render_frames_plain(scene, cam, cfg, 5, collect_stats=True,
                               intersect_fn=fn)
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("half", [HALF_PAST_LIMIT, HALF_100K])
def test_wide_kernel_equals_plain_bit_for_bit(cuda, half, adaptive):
    """Both wide scenes (global route, supers) through ``render_kernel`` and
    ``render_adaptive``, 96x54, 2 spp, 4 bounces: bit for bit the plain
    version in the kernel's forms; the call's launches counted (refill's
    two)."""
    scene, cam, cfg = wide_sphere_scene(tpresets, half, width=96, height=54,
                                        max_bounce=4, spp=2, device=cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    v = mk.variant("spheres", adaptive, tables="global")
    assert mk.path_name(scene, cfg) == v
    assert mk.geometry_tables(scene, "spheres").sph_supers is not None
    before = mk.KERNEL.variant_launches[v]
    _kernel_vs_plain(scene, cam, cfg)
    assert mk.KERNEL.variant_launches[v] == (
        before + mk.launches_per_call(cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tables", ["staged", "global"])
def test_staged_scene_with_supers_on_both_routes(cuda, tables, adaptive):
    """The RTIOW rule over an 80 x 80 grid (6,4xx spheres, 7 supers) fits a
    block's shared memory: on both table routes bit for bit the plain
    version in the kernel's forms."""
    scene, cam, cfg = wide_sphere_scene(tpresets, 40, width=96, height=54,
                                        max_bounce=4, spp=2, device=cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    tab = mk.geometry_tables(scene, "spheres")
    assert mk.table_route(tab, cfg) == "staged" and tab.sph_supers.shape[0] > 1
    _kernel_vs_plain(scene, cam, cfg, tables)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["staged", "global"])
@pytest.mark.parametrize("build_bvh, geom", TRIANGLE_GEOMETRIES)
def test_triangle_geometries_kernel_equals_plain(cuda, build_bvh, geom,
                                                 tables):
    """The RTIOW rule over an 80 x 80 grid (200 sphere clusters) beside a
    quad, through the chunk scan's and the BVH's instantiations, whose
    sphere scan is one level in the camera's order: 96x54, 2 spp, 4
    bounces, on both table routes bit for bit the plain version in the
    kernel's forms; one launch counted."""
    cam, cfg = rtiow_camera_and_config(tpresets, width=96, height=54,
                                       max_bounce=4, spp=2, device=cuda)
    scene = _add_quad(wide_sphere_builder(tpresets, 40)).build(
        build_bvh=build_bvh, device=cuda)
    assert mk.geometry(scene, cfg) == geom
    tab = mk.geometry_tables(scene, geom)
    assert tab.sph_supers is None and tab.clusters.shape[0] > SUPER
    assert mk.table_route(tab, cfg) == "staged"
    v = mk.variant(geom, False, tables=tables)
    before = mk.KERNEL.variant_launches[v]
    _kernel_vs_plain(scene, cam, cfg, tables)
    assert mk.KERNEL.variant_launches[v] == before + 1
