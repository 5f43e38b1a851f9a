"""The port's big-mesh path on the CPU against the JAX package: the LBVH
build, the BVH closest hit, ``mesh_scene`` through the renderer and the
loaders' BVH rule.

The build is host numpy code on both sides and is held bit for bit. The
traversal and its triangle test follow the JAX package's op for op, so on
random rays the hit flags and material rows agree exactly. Distances agree
within 1e-3 relative, not bit for bit: XLA's CPU backend contracts
multiply-adds into FMAs (the port, like the CUDA kernel, rounds each
operation), and the sphere root ``-b - sqrt(b^2 - cc)`` cancels, which
amplifies an ulp of ``b`` (measured: up to 1.1e-4). Whole frames are held
to the rule of ``tests/test_megakernel.py`` (over 99.5% of pixels within
1e-3, mean abs difference under 1e-3).
"""

import dataclasses
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ray_tracing_extended_tpu as rte
from ray_tracing_extended_tpu.accel import bvh as jbvh
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.models import scene as jscene
from ray_tracing_extended_tpu.scene import procedural as jproc
from ray_tracing_extended_tpu.scene.json_scene import load_json_scene as j_load
from ray_tracing_extended_tpu.utils import checkpoint as jckpt
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.accel import bvh as tbvh
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.models import scene as tscene
from ray_tracing_extended_tpu_torch.ops.intersect import closest_hit_bruteforce
from ray_tracing_extended_tpu_torch.scene import procedural as tproc
from ray_tracing_extended_tpu_torch.utils import checkpoint as tckpt

BVH_FIELDS = ("bounds_min", "bounds_max", "left", "right", "leaf_row",
              "leaf_prims")
SMALL_MESH = dict(width=48, height=27, target_tris=4000)
SCENES = pathlib.Path(rtt.__file__).resolve().parent.parent / "scenes"


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


def _tight(a, b):
    """tests/test_megakernel.py's whole-frame rule."""
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


def _assert_same_bvh(j, t):
    for name in BVH_FIELDS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _trefoil_boxes():
    v, f = jproc.trefoil_knot_mesh(4000)
    tri = v[f]
    return tri.min(axis=1), tri.max(axis=1), len(f)


def _random_boxes():
    rs = np.random.RandomState(3)
    bmin = rs.uniform(-10, 10, (333, 3)).astype(np.float32)
    bmax = bmin + rs.uniform(0.01, 1.0, (333, 3)).astype(np.float32)
    return bmin, bmax, 333


@pytest.mark.parametrize("boxes", [_trefoil_boxes, _random_boxes])
def test_build_lbvh_matches_jax(boxes):
    """The same arrays, bit for bit (the JAX side may take its native build,
    which its own tests hold identical to its NumPy build)."""
    bmin, bmax, n = boxes()
    j = jbvh.build_lbvh(bmin, bmax, sentinel=n)
    t = tbvh.build_lbvh(bmin, bmax, sentinel=n)
    _assert_same_bvh(j, t)
    assert t.leaf_prims.shape[1] == tbvh.LEAF_WIDTH == 4
    assert int(t.leaf_prims.max()) == n  # padded leaves hold the sentinel


def test_build_refuses_a_tree_deeper_than_the_stack():
    n = tbvh.STACK_DEPTH + 1
    left = np.append(np.arange(1, n), -1).astype(np.int32)  # a chain
    right = np.full(n, -1, np.int32)
    with pytest.raises(ValueError, match="exceeds the device traversal stack"):
        tbvh._assert_traversable(left, right)
    tbvh._assert_traversable(left[1:] - 1, right[1:])  # one level less


def test_procedural_meshes_identical():
    for j, t in ((jproc.trefoil_knot_mesh(4000), tproc.trefoil_knot_mesh(4000)),
                 (jproc.uv_sphere_mesh(), tproc.uv_sphere_mesh())):
        for a, b in zip(j, t):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _mixed_scene(mod, bvh, **build):
    """Spheres and a posed uv-sphere mesh, through either package's
    builder (tests/test_bvh.py's scene)."""
    rs = np.random.RandomState(0)
    b = mod.SceneBuilder()
    for _ in range(60):
        b.add_sphere(rs.uniform(-4, 4, 3), rs.uniform(0.1, 0.7),
                     mod.Material.lambertian(rs.uniform(0.2, 0.9, 3)))
    v, f = jproc.uv_sphere_mesh(12, 24, 1.2)
    b.add_mesh(v, f, mod.Material.lambertian((0.5, 0.5, 0.8)),
               transform=np.array([[1, 0, 0, 0.5], [0, 1, 0, -0.3],
                                   [0, 0, 1, 0.2], [0, 0, 0, 1]], np.float32))
    return b.build(build_bvh=bvh, **build)


@pytest.mark.parametrize("bvh", ["tri", "sphere", "both"])
def test_scene_build_bvh_matches_jax(bvh):
    """``build(build_bvh=...)`` gives the JAX package's BVHs, and interop
    carries them across."""
    j = _mixed_scene(jscene, bvh)
    t = _mixed_scene(tscene, bvh, device="cpu")
    via = scene_from_arrays(j, device="cpu")
    for name in ("tri_bvh", "sphere_bvh"):
        jb, tb = getattr(j, name), getattr(t, name)
        assert (jb is None) == (tb is None) == (getattr(via, name) is None)
        if jb is not None:
            _assert_same_bvh(jb, tb)
            _assert_same_bvh(jb, getattr(via, name))
    assert t.has_tri_bvh == (bvh != "sphere")
    # the BVHs derive from the scene: the checkpoint fingerprint skips them
    plain = _mixed_scene(tscene, None, device="cpu")
    assert tckpt.hash_tree(t) == tckpt.hash_tree(plain)


def _rays(n=512, seed=1):
    """Rays from a box around the scene towards points inside it."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = (rs.uniform(-2, 2, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_closest_hit_bvh_matches_jax():
    """On a scene with spheres and triangles, both under BVHs, and with a
    triangle BVH only: hit flags and material rows exactly, t and normals
    within the module's tolerance."""
    o, d = _rays()
    for bvh in ("both", "tri"):
        js = _mixed_scene(jscene, bvh)
        ts = scene_from_arrays(js, device="cpu")
        a = jbvh.closest_hit_bvh(jnp.asarray(o), jnp.asarray(d), js)
        b = tbvh.closest_hit_bvh(torch.from_numpy(o), torch.from_numpy(d), ts)
        hit = np.asarray(a.hit)
        assert hit.mean() > 0.3
        assert np.array_equal(hit, b.hit.numpy())
        np.testing.assert_allclose(b.t.numpy()[hit], np.asarray(a.t)[hit],
                                   rtol=1e-3, atol=0)
        assert np.array_equal(np.asarray(a.mat_idx), b.mat_idx.numpy())
        np.testing.assert_allclose(b.normal.numpy()[hit],
                                   np.asarray(a.normal)[hit], atol=1e-3)


def test_closest_hit_bvh_matches_bruteforce():
    """The port's traversal against the port's scan: the same hits and
    winners (only exact ties could differ, and random rays make none); t
    within 1e-3 relative, as the scan's spheres take the expanded
    quadratic and the traversal's the direct one."""
    o, d = (torch.from_numpy(x) for x in _rays(seed=2))
    ts = _mixed_scene(tscene, "both", device="cpu")
    a = closest_hit_bruteforce(o, d, ts)
    for sphere_bvh in (True, False):
        b = tbvh.closest_hit_bvh(o, d, ts, sphere_bvh=sphere_bvh)
        assert torch.equal(a.hit, b.hit)
        hit = a.hit
        torch.testing.assert_close(b.t[hit], a.t[hit], rtol=1e-3, atol=0)
        assert torch.equal(a.mat_idx, b.mat_idx)


def _one_ray_counts(o, d, scene, sentinel):
    """One ray at a time, in plain Python, through the port's own slab and
    triangle tests: the slab tests the traversal needs (the root, then both
    children of each internal node visited), and the real and all slots of
    the leaves visited."""
    bvh = scene.tri_bvh
    slabs = real = slots = 0
    for r in range(o.shape[0]):
        o1, d1 = o[r:r + 1], d[r:r + 1]
        inv = 1.0 / d1
        best = torch.full((1,), float("inf"))

        def passes(node):
            tn, tf = tbvh._slab(o1, inv, bvh.bounds_min[node][None],
                                bvh.bounds_max[node][None])
            return bool(((tf >= 0) & (tn <= torch.minimum(tf, best)))[0]), tn

        stack = [0]
        slabs += 1
        while stack:
            node = stack.pop()
            if not passes(node)[0]:
                continue
            row = int(bvh.leaf_row[node])
            if row >= 0:
                for p in bvh.leaf_prims[row].tolist():
                    real += p < sentinel
                    slots += 1
                    t = tbvh._triangle_t_one(o1, d1, scene, torch.tensor([p]))
                    best = torch.minimum(best, t)
                continue
            left, right = int(bvh.left[node]), int(bvh.right[node])
            slabs += 2
            (hl, tnl), (hr, tnr) = passes(left), passes(right)
            if hl and hr:
                near, far = (left, right) if bool(tnl <= tnr) else (right, left)
                stack += [far, near]
            elif hl or hr:
                stack.append(left if hl else right)
    return slabs, real, slots


def test_traverse_counts_the_tests_it_needs():
    """``closest_hit_bvh``'s counts (the bound's work in the GPU smoke
    run) against a one-ray-at-a-time recount: the root and the children's
    slab tests, the real triangles of the leaves visited (not their padding
    slots); a parked ray (origin 1e9, direction +x) costs one root test."""
    ts = _mixed_scene(tscene, "tri", device="cpu")
    o, d = (torch.from_numpy(x) for x in _rays(n=48, seed=4))
    o[-4:], d[-4:] = 1.0e9, torch.tensor([1.0, 0.0, 0.0])
    sentinel = int(ts.chunks.num_tris.sum())
    counts = {}
    tbvh.closest_hit_bvh(o, d, ts, counts=counts)
    slabs, real, slots = _one_ray_counts(o, d, ts, sentinel)
    assert (counts["slabs"], counts["prims"]) == (slabs, real)
    assert real < slots  # the leaves visited hold padding slots
    parked = {}
    tbvh.closest_hit_bvh(o[-4:], d[-4:], ts, counts=parked)
    assert parked == {"slabs": 4}


def _mesh(**kw):
    js, jc, cfg = jpresets.mesh_scene(**{**SMALL_MESH, **kw})
    ts, tc, tcfg = tpresets.mesh_scene(**{**SMALL_MESH, **kw}, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return js, jc, ts, tc, cfg


def test_mesh_scene_identical():
    js, jc, ts, tc, cfg = _mesh()
    assert ts.triangles.count == js.triangles.pos_a.shape[0] == 4096
    assert int(ts.chunks.num_tris.sum()) == 3968  # 31 rings x 64 x 2
    assert ts.has_tri_bvh and ts.sphere_bvh is None
    _assert_same_bvh(js.tri_bvh, ts.tri_bvh)
    for name in ("pos_a", "edge_ab", "edge_ac", "normal_a", "n", "mat_idx"):
        assert np.array_equal(np.asarray(getattr(js.triangles, name)),
                              getattr(ts.triangles, name).numpy()), name
    assert tmk.geometry(ts, cfg) == "bvh"
    assert tmk.geometry(ts, dataclasses.replace(cfg, intersector="bruteforce")) \
        == "chunks"
    assert tckpt.state_hash(ts, tc, cfg) == jckpt.state_hash(js, jc, cfg)


def test_mesh_scene_frame_matches_xla():
    """The port's plain BVH path against the JAX package's XLA BVH path:
    the whole-frame rule, the same segment total and bounce histogram."""
    js, jc, ts, tc, cfg = _mesh()
    a, a_segs, a_hist = rte.render_frame_with_stats(js, jc, cfg, jnp.uint32(3),
                                                    bounce_stats=True)
    b, b_segs, b_hist = rtt.render_frame_with_stats(ts, tc, cfg, 3,
                                                    bounce_stats=True)
    _tight(np.asarray(a), b.numpy())
    assert int(b_segs) == int(a_segs)
    assert np.array_equal(b_hist.numpy(), np.asarray(a_hist))


def test_mesh_scene_fold_matches_xla():
    """The K-frame fold from a seeded accumulator on both packages."""
    js, jc, ts, tc, cfg = _mesh(max_bounce=2)
    prev = np.random.RandomState(0).uniform(0, 1.5, (27, 48, 3)).astype(np.float32)
    a, a_segs = rte.render_frames_and_accumulate(js, jc, cfg, jnp.asarray(prev),
                                                 jnp.uint32(2), n_frames=3)
    b, b_segs = rtt.render_frames_and_accumulate(ts, tc, cfg,
                                                 torch.from_numpy(prev), 2, 3)
    _tight(np.asarray(a), b.numpy())
    assert int(b_segs) == int(a_segs)


def test_mesh_scene_bvh_equals_scan():
    """Through the BVH ("auto", "bvh", "mega") and by scan ("bruteforce")
    the port renders the same frame: only exact ties could differ."""
    _, _, ts, tc, cfg = _mesh(max_bounce=2)
    ref = tmk.render_frames_plain(ts, tc, cfg, 1)[0]
    for intersector in ("bvh", "mega", "bruteforce"):
        other = dataclasses.replace(cfg, intersector=intersector)
        img = rtt.render_frame(ts, tc, other, 1)
        _tight(ref.numpy(), img.numpy())
    assert tmk.plain_block_size(cfg, ts, 48 * 27) == 48 * 27 // 256 * 256 + 256


def test_json_scene_big_obj_gets_a_bvh(tmp_path):
    """A JSON scene whose OBJ has more than 4096 faces gets a triangle BVH,
    as in the JAX package (the shipped mirrors stay under the rule)."""
    v, f = jproc.trefoil_knot_mesh(5000)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in f]
    (tmp_path / "knot.obj").write_text("\n".join(lines) + "\n")
    spec = tmp_path / "knot.json"
    spec.write_text('{"meshes": [{"obj": "knot.obj", "chunked": false}], '
                    '"camera": {"position": [0, 1, -6]}}')
    small = dict(width=32, height=18, spp=1, max_bounce=1)
    js, jc, cfg = j_load(spec, overrides=small)
    ts, tc, tcfg = rtt.load_json_scene(spec, overrides=small, device="cpu")
    assert js.tri_bvh is not None and ts.has_tri_bvh
    _assert_same_bvh(js.tri_bvh, ts.tri_bvh)
    a = rte.render_frame(js, jc, cfg, jnp.uint32(1))
    b = rtt.render_frame(ts, tc, tcfg, 1)
    _tight(np.asarray(a), b.numpy())
    # the largest shipped mirror stays under the rule: scanned by chunk
    chess, _, _ = rtt.load_json_scene(SCENES / "chess.json", device="cpu")
    assert not chess.has_tri_bvh


def test_rtiow_sphere_bvh_matches_xla():
    """rtiow_final_scene(build_bvh="sphere"): the sphere BVH's arrays, and
    the plain path traversing it against the XLA path traversing the
    JAX package's, at one segment a path."""
    js, jc, cfg = jpresets.rtiow_final_scene(width=32, height=18, spp=1,
                                             max_bounce=0, build_bvh="sphere")
    ts, tc, tcfg = tpresets.rtiow_final_scene(width=32, height=18, spp=1,
                                              max_bounce=0, build_bvh="sphere",
                                              device="cpu")
    _assert_same_bvh(js.sphere_bvh, ts.sphere_bvh)
    a = rte.render_frame(js, jc, cfg, jnp.uint32(2))
    b = rtt.render_frame(ts, camera_from_arrays(jc, device="cpu"), tcfg, 2)
    assert (np.abs(np.asarray(a) - b.numpy()).max(axis=-1) < 1e-3).mean() > 0.98
