"""The port's big-mesh path on the CPU against the JAX package: the LBVH
build, the BVH closest hit, ``mesh_scene`` through the renderer and the
loaders' BVH rule; and the port's own binned-SAH build, the scene's
triangle tree.

The LBVH build is host numpy code on both sides and is held bit for bit; a
scene's triangle tree is the SAH build over the boxes whose LBVH is the
JAX package's (``tests/scene_bvhs.py``). The
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
from ray_tracing_extended_tpu_torch.scene.json_scene import (
    load_json_scene as t_load,
)
from ray_tracing_extended_tpu_torch.utils import checkpoint as tckpt
from scene_bvhs import (
    BOX_SETS,
    assert_scene_tri_bvh,
    dog_boxes,
    record_tri_boxes,
)

BVH_FIELDS = ("bounds_min", "bounds_max", "left", "right", "leaf_row",
              "leaf_prims")
SMALL_MESH = dict(width=48, height=27, target_tris=4000)
ROOT = pathlib.Path(rtt.__file__).resolve().parent.parent
SCENES = ROOT / "scenes"
DOG = ROOT / "benchmark" / "scenes" / "dmc-dog-skin.json"


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
def test_scene_build_bvh_matches_jax(monkeypatch, bvh):
    """``build(build_bvh=...)`` gives the JAX package's sphere BVH; over
    the triangle boxes it passed, the port's LBVH is the JAX package's
    triangle tree and the scene's is ``build_sah_bvh``'s; interop carries
    the JAX package's trees across."""
    boxes = record_tri_boxes(monkeypatch)
    j = _mixed_scene(jscene, bvh)
    t = _mixed_scene(tscene, bvh, device="cpu")
    via = scene_from_arrays(j, device="cpu")
    for name in ("tri_bvh", "sphere_bvh"):
        jb, tb = getattr(j, name), getattr(t, name)
        assert (jb is None) == (tb is None) == (getattr(via, name) is None)
        if jb is not None:
            if name == "tri_bvh":
                assert_scene_tri_bvh(tb, jb, boxes)
            else:
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
    triangle tests, with the slab test repeated at each pop: the slab tests
    the traversal needs (the root, then both children of each internal
    node visited), the real and all slots of the leaves visited, the pops
    and pop rejects (the root's pop included), the internal nodes and
    leaves visited."""
    bvh = scene.tri_bvh
    n = dict(slabs=0, real=0, slots=0, pops=0, pop_rejects=0, internal=0,
             leaves=0)
    for r in range(o.shape[0]):
        o1, d1 = o[r:r + 1], d[r:r + 1]
        inv = 1.0 / d1
        best = torch.full((1,), float("inf"))

        def passes(node):
            tn, tf = tbvh._slab(o1, inv, bvh.bounds_min[node][None],
                                bvh.bounds_max[node][None])
            return bool(((tf >= 0) & (tn <= torch.minimum(tf, best)))[0]), tn

        stack = [0]
        n["slabs"] += 1
        while stack:
            node = stack.pop()
            n["pops"] += 1
            if not passes(node)[0]:
                n["pop_rejects"] += 1
                continue
            row = int(bvh.leaf_row[node])
            if row >= 0:
                n["leaves"] += 1
                for p in bvh.leaf_prims[row].tolist():
                    n["real"] += p < sentinel
                    n["slots"] += 1
                    t = tbvh._triangle_t_one(o1, d1, scene, torch.tensor([p]))
                    best = torch.minimum(best, t)
                continue
            n["internal"] += 1
            left, right = int(bvh.left[node]), int(bvh.right[node])
            n["slabs"] += 2
            (hl, tnl), (hr, tnr) = passes(left), passes(right)
            if hl and hr:
                near, far = (left, right) if bool(tnl <= tnr) else (right, left)
                stack += [far, near]
            elif hl or hr:
                stack.append(left if hl else right)
    return n


def test_traverse_counts_the_tests_it_needs():
    """``closest_hit_bvh``'s counts (the bound's work in the GPU smoke
    run) against a one-ray-at-a-time recount: the root and the children's
    slab tests, the real triangles of the leaves visited (not their padding
    slots), the pops and pop rejects, the nodes visited and the bytes the
    kernel reads for them; a parked ray (origin 1e9, direction +x) costs
    one root test, counted as a rejected pop."""
    ts = _mixed_scene(tscene, "tri", device="cpu")
    o, d = (torch.from_numpy(x) for x in _rays(n=48, seed=4))
    o[-4:], d[-4:] = 1.0e9, torch.tensor([1.0, 0.0, 0.0])
    sentinel = int(ts.chunks.num_tris.sum())
    counts = {}
    tbvh.closest_hit_bvh(o, d, ts, counts=counts)
    n = _one_ray_counts(o, d, ts, sentinel)
    assert (counts["slabs"], counts["prims"]) == (n["slabs"], n["real"])
    for key in ("pops", "pop_rejects", "internal", "leaves"):
        assert counts[key] == n[key], key
    assert counts["fetched_bytes"] == (
        48 * tbvh.ROOT_BYTES + n["internal"] * tbvh.NODE_ROW_BYTES
        + n["leaves"] * tbvh.LEAF_ROW_BYTES + n["real"] * tbvh.PRIM_ROW_BYTES)
    assert n["real"] < n["slots"]  # the leaves visited hold padding slots
    assert 0 < n["pop_rejects"] < n["pops"]
    parked = {}
    tbvh.closest_hit_bvh(o[-4:], d[-4:], ts, counts=parked)
    assert parked == {"slabs": 4, "prims": 0, "pops": 4, "pop_rejects": 4,
                      "internal": 0, "leaves": 0,
                      "fetched_bytes": 4 * tbvh.ROOT_BYTES}


# ---- the kernel's node table and its traversal ----------------------------

def _node_table_cases(name, tmp_path):
    """(BVH, leaves' sentinel) of mesh_scene, a small procedural mesh and a
    JSON scene with a big OBJ (the loader's BVH rule)."""
    if name == "json_big_obj":
        v, f = jproc.trefoil_knot_mesh(5000)
        lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in f]
        (tmp_path / "knot.obj").write_text("\n".join(lines) + "\n")
        spec = tmp_path / "knot.json"
        spec.write_text('{"meshes": [{"obj": "knot.obj", "chunked": false}], '
                        '"camera": {"position": [0, 1, -6]}}')
        scene = rtt.load_json_scene(spec, device="cpu")[0]
    else:
        kw = {} if name == "mesh_scene" else dict(target_tris=4000)
        scene = tpresets.mesh_scene(device="cpu", **kw)[0]
    return scene.tri_bvh, int(scene.chunks.num_tris.sum())


@pytest.mark.parametrize("name", ["mesh_scene", "small_mesh", "json_big_obj"])
def test_node_table_restates_the_bvh(name, tmp_path):
    """``bvh_node_table`` restates the BVH bit for bit: row 0 the root's
    box, each internal node's row its children's boxes; each reference
    decodes to the child node or to the child's leaf row with its count of
    real slots, and those slots come first."""
    bvh, sentinel = _node_table_cases(name, tmp_path)
    lo, hi, left, right, leaf_row, prims = (
        getattr(bvh, f).numpy() for f in BVH_FIELDS[:5] + ("leaf_prims",))
    table = tmk.bvh_node_table(bvh, sentinel)
    internal = np.nonzero(leaf_row < 0)[0]
    assert table.shape == (1 + len(internal), 16) and table.dtype == np.float32
    bits = table.view(np.int32)
    n_real = (prims < sentinel).sum(axis=1)
    assert (n_real >= 1).all()
    assert np.array_equal(prims < sentinel,
                          np.arange(prims.shape[1]) < n_real[:, None])

    def same(a, b):
        return np.array_equal(a.view(np.int32), b.view(np.int32))

    def decodes(refs, nodes):
        leaf = leaf_row[nodes] >= 0
        if (refs[~leaf] < 1).any():
            return False
        ok_int = np.array_equal(internal[refs[~leaf] - 1], nodes[~leaf])
        v = ~refs[leaf]
        rows = v >> tmk.LEAF_COUNT_BITS
        return (ok_int and (refs[leaf] < 0).all()
                and np.array_equal(rows, leaf_row[nodes[leaf]])
                and np.array_equal(v & ((1 << tmk.LEAF_COUNT_BITS) - 1),
                                   n_real[rows]))

    assert same(table[0, 0:3], lo[0]) and same(table[0, 4:7], hi[0])
    assert decodes(bits[:1, 3], np.array([0]))
    assert not bits[0, 7:].any()
    for col, child in ((0, left[internal]), (8, right[internal])):
        assert same(table[1:, col:col + 3], lo[child])
        assert same(table[1:, col + 4:col + 7], hi[child])
        assert decodes(bits[1:, col + 3], child)
        assert not bits[1:, col + 7].any()
    assert int(leaf_row.max()) < 1 << (31 - tmk.LEAF_COUNT_BITS)


def _traverse_with_pop_retest(o, d, bvh, prim_t_fn, best_t, best_idx,
                              counts=None, sentinel=None):
    """The traversal as the kernel first ran it, kept as the yardstick of
    the redesigned one: every pop slab-tests its node again, a leaf tests
    all its slots (padding included); counts as ``tbvh._traverse``'s
    ``slabs`` and ``prims``."""
    b = o.shape[0]
    dev = o.device
    d_inv = 1.0 / d
    leaf_width = bvh.leaf_prims.shape[1]
    n_nodes = bvh.left.shape[0]
    best_t, best_idx = best_t.clone(), best_idx.clone()
    stack = torch.zeros((b, tbvh.STACK_DEPTH), dtype=torch.int64, device=dev)
    # every ray starts with the root on its stack
    ptr = torch.ones(b, dtype=torch.int64, device=dev)
    lanes = torch.arange(b, device=dev)
    if counts is not None:
        counts["slabs"] = counts.get("slabs", 0) + b
    for _ in range(4 * n_nodes):
        if lanes.numel() == 0:
            break
        p = ptr[lanes] - 1
        node = stack[lanes, p]
        ptr[lanes] = p
        o_l, d_l, inv_l = o[lanes], d[lanes], d_inv[lanes]
        bt = best_t[lanes]
        t_near, t_far = tbvh._slab(o_l, inv_l, bvh.bounds_min[node],
                                   bvh.bounds_max[node])
        visit = (t_far >= 0.0) & (t_near <= torch.minimum(t_far, bt))
        row = bvh.leaf_row[node].long()
        is_leaf = row >= 0

        # leaves: every slot, in order, strictly nearer wins
        lf = (visit & is_leaf).nonzero().squeeze(1)
        if lf.numel():
            prims = bvh.leaf_prims[row[lf]].long()  # (n, leaf_width)
            if counts is not None:
                real = prims.numel() if sentinel is None else int(
                    (prims < sentinel).sum())
                counts["prims"] = counts.get("prims", 0) + real
            t_all = prim_t_fn(o_l[lf, None], d_l[lf, None], prims)
            bt_f, bi_f = bt[lf], best_idx[lanes[lf]]
            for j in range(leaf_width):
                better = t_all[:, j] < bt_f
                bt_f = torch.where(better, t_all[:, j], bt_f)
                bi_f = torch.where(better, prims[:, j], bi_f)
            best_t[lanes[lf]] = bt_f
            best_idx[lanes[lf]] = bi_f

        # internal nodes: slab-test both children, push the survivors far
        # first (the near one pops next)
        it = (visit & ~is_leaf).nonzero().squeeze(1)
        if it.numel():
            li = lanes[it]
            o_i, inv_i, bt_i = o_l[it], inv_l[it], bt[it]
            l_node = bvh.left[node[it]].long()
            r_node = bvh.right[node[it]].long()
            tn_l, tf_l = tbvh._slab(o_i, inv_i, bvh.bounds_min[l_node],
                                    bvh.bounds_max[l_node])
            tn_r, tf_r = tbvh._slab(o_i, inv_i, bvh.bounds_min[r_node],
                                    bvh.bounds_max[r_node])
            hit_l = (tf_l >= 0.0) & (tn_l <= torch.minimum(tf_l, bt_i))
            hit_r = (tf_r >= 0.0) & (tn_r <= torch.minimum(tf_r, bt_i))
            both = hit_l & hit_r
            l_is_near = tn_l <= tn_r
            near = torch.where(l_is_near, l_node, r_node)
            far = torch.where(l_is_near, r_node, l_node)
            first = torch.where(both, far, torch.where(hit_l, l_node, r_node))
            any_push = hit_l | hit_r
            p_i = ptr[li]
            p0 = torch.clamp(p_i, max=tbvh.STACK_DEPTH - 1)
            p1 = torch.clamp(p_i + 1, max=tbvh.STACK_DEPTH - 1)
            stack[li, p0] = torch.where(any_push, first, stack[li, p0])
            stack[li, p1] = torch.where(both, near, stack[li, p1])
            ptr[li] = p_i + any_push.long() + both.long()
            if counts is not None:
                counts["slabs"] += 2 * it.numel()
        lanes = lanes[ptr[lanes] > 0]
    return best_t, best_idx


def _mesh_rays(scene, n=10_000, seed=7):
    """Seeded rays into mesh_scene: from a box around the knot towards it,
    up from the ground (origins on the ground sphere's top, y = 0), and
    rays whose direction has a zero component with the origin on a BVH
    node's face in that axis (their slab with that node is NaN: the node is
    rejected)."""
    rs = np.random.RandomState(seed)
    n_nan = n_ground = n // 5
    n_box = n - n_nan - n_ground
    o = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = (rs.uniform(-0.8, 0.8, (n, 3)) + [0.0, 0.8, 0.0] - o).astype(np.float32)
    g = slice(n_box, n_box + n_ground)
    o[g] = rs.uniform(-1.2, 1.2, (n_ground, 3)) * [1.0, 0.0, 0.5]
    d[g] = rs.normal(size=(n_ground, 3)).astype(np.float32)
    d[g, 1] = np.abs(d[g, 1]) + 0.5
    bvh = scene.tri_bvh
    nan = slice(n_box + n_ground, n)
    nodes = rs.randint(0, bvh.left.shape[0], n_nan)
    axis = rs.randint(0, 3, n_nan)
    face = np.where(rs.rand(n_nan) < 0.5, bvh.bounds_min.numpy()[nodes, axis],
                    bvh.bounds_max.numpy()[nodes, axis])
    rows = np.arange(nan.start, n)
    o[rows, axis] = face
    d[rows, axis] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d), nodes


def test_traversal_equals_the_pop_retest_algorithm():
    """The redesigned plain traversal (t_near on the stack, no slab test at
    the pop, real slots only) against the traversal the kernel first ran
    (kept above): ``(t, index)`` bit for bit on 10^4 seeded rays into
    mesh_scene, NaN-rule and ground rays included, and the same slab and
    triangle counts."""
    scene = tpresets.mesh_scene(device="cpu")[0]
    bvh = scene.tri_bvh
    o, d, nodes = _mesh_rays(scene)
    sentinel = int(scene.chunks.num_tris.sum())
    nan = slice(o.shape[0] - nodes.shape[0], o.shape[0])
    t_near, _ = tbvh._slab(o[nan], 1.0 / d[nan], bvh.bounds_min[nodes],
                           bvh.bounds_max[nodes])
    assert bool(torch.isnan(t_near).all())  # each meets the NaN rule

    def prim_t(o_, d_, idx):
        return tbvh._triangle_t_one(o_, d_, scene, idx)

    inf = torch.full((o.shape[0],), float("inf"))
    zero = torch.zeros(o.shape[0], dtype=torch.int64)
    new_counts, old_counts = {}, {}
    t_new, i_new = tbvh._traverse(o, d, bvh, prim_t, inf, zero, new_counts,
                                  sentinel)
    t_old, i_old = _traverse_with_pop_retest(o, d, bvh, prim_t, inf, zero,
                                             old_counts, sentinel)
    assert torch.equal(t_new.view(torch.int32), t_old.view(torch.int32))
    assert torch.equal(i_new, i_old)
    hit = torch.isfinite(t_new)
    for part in (slice(0, 6000), slice(6000, 8000), nan):
        assert 0.05 < float(hit[part].double().mean()) < 0.95
    assert (new_counts["slabs"], new_counts["prims"]) == (
        old_counts["slabs"], old_counts["prims"])


def _assert_mesh_frame_counts(scene, cam, cfg, want):
    """Stats frame 8's traversal counts a live segment within 1% of
    ``want``, and the bytes read by the node table's layout."""
    counts = {}
    tmk.render_frames_plain(scene, cam, cfg, 8,
                            intersect_fn=tmk.plain_intersector(
                                scene, cam, cfg, counts))
    n, parked = counts["segments"], counts["parked"]
    assert n == 26_340
    for key, value in want.items():
        got = (counts[key] - (parked if key in ("pops", "pop_rejects", "slabs")
                              else 0)) / n
        assert abs(got - value) <= 0.01 * value, (key, got)
    assert counts["fetched_bytes"] == (
        (n + parked) * tbvh.ROOT_BYTES + counts["internal"] * tbvh.NODE_ROW_BYTES
        + counts["leaves"] * tbvh.LEAF_ROW_BYTES
        + counts["prims"] * tbvh.PRIM_ROW_BYTES)


def test_traversal_counts_on_the_mesh_frame():
    """The counts behind the GPU smoke run's BVH bound, on mesh_scene at
    160x90 (stats frame 8, 1 spp, 4 bounces: 26,340 live segments) through
    its binned-SAH tree: within 1% of what the plain traversal counts there
    (pops 16.92, pop rejects 0.889, internal nodes 14.51, leaves 1.516,
    slab tests 30.03, triangles 5.049 a live segment; a parked dead lane's
    root test is no work), and the bytes read by the node table's layout.
    The LBVH's are the next test's."""
    scene, cam, cfg = tpresets.mesh_scene(width=160, height=90, device="cpu")
    _assert_mesh_frame_counts(scene, cam, cfg, dict(
        pops=16.92, pop_rejects=0.889, internal=14.51, leaves=1.516,
        slabs=30.03, prims=5.049))


def test_traversal_counts_on_the_mesh_frame_through_the_lbvh(monkeypatch):
    """The same frame through the LBVH over the same boxes, the tree the
    scene held before the SAH build: within 1% of what the pop-retest
    traversal counts there (pops 20.87, pop rejects 0.961, internal nodes
    18.22, leaves 1.69, slab tests 37.44, triangles 5.31 a live segment),
    and the same 26,340 segments: the tree moves the work, not the
    paths."""
    boxes = record_tri_boxes(monkeypatch)
    scene, cam, cfg = tpresets.mesh_scene(width=160, height=90, device="cpu")
    bmin, bmax, sentinel = boxes[-1]
    lbvh = dataclasses.replace(
        scene, tri_bvh=tbvh.build_lbvh(bmin, bmax, sentinel=sentinel))
    _assert_mesh_frame_counts(lbvh, cam, cfg, dict(
        pops=20.87, pop_rejects=0.961, internal=18.22, leaves=1.69,
        slabs=37.44, prims=5.31))


def _mesh(**kw):
    js, jc, cfg = jpresets.mesh_scene(**{**SMALL_MESH, **kw})
    ts, tc, tcfg = tpresets.mesh_scene(**{**SMALL_MESH, **kw}, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return js, jc, ts, tc, cfg


def test_mesh_scene_identical(monkeypatch):
    """The same scene arrays as the JAX package's; the triangle tree is
    the SAH build over the boxes whose LBVH is the JAX package's."""
    boxes = record_tri_boxes(monkeypatch)
    js, jc, ts, tc, cfg = _mesh()
    assert ts.triangles.count == js.triangles.pos_a.shape[0] == 4096
    assert int(ts.chunks.num_tris.sum()) == 3968  # 31 rings x 64 x 2
    assert ts.has_tri_bvh and ts.sphere_bvh is None
    assert_scene_tri_bvh(ts.tri_bvh, js.tri_bvh, boxes)
    for name in ("pos_a", "edge_ab", "edge_ac", "normal_a", "n", "mat_idx"):
        assert np.array_equal(np.asarray(getattr(js.triangles, name)),
                              getattr(ts.triangles, name).numpy()), name
    assert tmk.geometry(ts, cfg) == "bvh"
    assert tmk.geometry(ts, dataclasses.replace(cfg, intersector="bruteforce")) \
        == "chunks"
    assert tckpt.state_hash(ts, tc, cfg) == jckpt.state_hash(js, jc, cfg)


def _mesh_frame_both(**kw):
    """Frame 3 of the small mesh on the JAX package's XLA BVH path and the
    port's plain one, held to the whole-frame rule and the same segment
    total; returns the port's inputs and both bounce histograms."""
    js, jc, ts, tc, cfg = _mesh(**kw)
    a, a_segs, a_hist = rte.render_frame_with_stats(js, jc, cfg, jnp.uint32(3),
                                                    bounce_stats=True)
    b, b_segs, b_hist = rtt.render_frame_with_stats(ts, tc, cfg, 3,
                                                    bounce_stats=True)
    _tight(np.asarray(a), b.numpy())
    assert int(b_segs) == int(a_segs)
    return ts, tc, cfg, int(b_segs), np.asarray(a_hist), b_hist


def test_mesh_scene_frame_matches_xla():
    """The port's plain BVH path against the JAX package's XLA BVH path at
    48x27: the whole-frame rule and the same segment total. The XLA path's
    histogram also counts the padding lanes of its last pixel block, the
    port's real pixels only: every real path at bounce 0, summing to the
    per-pixel segment map."""
    ts, tc, cfg, segs, _, hist = _mesh_frame_both()
    seg_map = tmk.render_frames_plain(ts, tc, cfg, 3)[2]
    assert int(hist[0]) == 48 * 27 * cfg.spp
    assert int(hist.sum()) == int(seg_map.sum()) < segs


def test_mesh_scene_histogram_matches_xla_without_padding():
    """At 64x32 neither path has padding lanes: the same image, segment
    total and bounce histogram."""
    *_, xla_hist, hist = _mesh_frame_both(width=64, height=32)
    assert np.array_equal(hist.numpy(), xla_hist)


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


def test_json_scene_big_obj_gets_a_bvh(tmp_path, monkeypatch):
    """A JSON scene whose OBJ has more than 4096 faces gets a triangle BVH,
    as in the JAX package (the shipped mirrors stay under the rule): the
    SAH tree over the boxes whose LBVH is the JAX package's."""
    boxes = record_tri_boxes(monkeypatch)
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
    assert_scene_tri_bvh(ts.tri_bvh, js.tri_bvh, boxes)
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


# ---- the binned-SAH build, the scene's triangle tree ----------------------

def _sah_tree(case):
    bmin, bmax = BOX_SETS[case]()
    n = len(bmin)
    return tbvh.build_sah_bvh(bmin, bmax, sentinel=n), bmin, bmax, n


@pytest.mark.parametrize("case", sorted(BOX_SETS))
def test_sah_tree_holds_every_primitive_once(case):
    """Each primitive in exactly one leaf slot; a leaf's real slots first,
    then the sentinel; ``leaf_row`` -1 exactly at internal nodes; and the
    numbering ``build_lbvh``'s: root 0, a node's two children made
    together when it is taken from the work stack, the left subtree
    first, the leaf rows in that order."""
    bvh, _, _, n = _sah_tree(case)
    left, right, leaf_row, prims = (getattr(bvh, f).numpy() for f in (
        "left", "right", "leaf_row", "leaf_prims"))
    real = prims < n
    assert np.array_equal(np.sort(prims[real]), np.arange(n))
    assert (prims[~real] == n).all()
    assert np.array_equal(real, np.arange(tbvh.LEAF_WIDTH)
                          < real.sum(axis=1)[:, None])
    assert real.sum(axis=1).min() >= 1
    assert np.array_equal(leaf_row < 0, left >= 0)
    assert np.array_equal(left < 0, right < 0)
    next_node, next_row, work = 1, 0, [0]
    while work:
        k = work.pop()
        if left[k] < 0:
            assert leaf_row[k] == next_row
            next_row += 1
            continue
        assert (left[k], right[k]) == (next_node, next_node + 1)
        next_node += 2
        work += [int(right[k]), int(left[k])]
    assert (next_node, next_row) == (len(left), len(prims))


@pytest.mark.parametrize("case", sorted(BOX_SETS))
def test_sah_tree_boxes_hold_their_children(case):
    """Every internal node's box is the union of its children's, every
    leaf's the union of its primitives' boxes, so a box holds all below
    it."""
    bvh, bmin, bmax, n = _sah_tree(case)
    lo, hi, left, right, leaf_row, prims = (getattr(bvh, f).numpy() for f in (
        "bounds_min", "bounds_max", "left", "right", "leaf_row",
        "leaf_prims"))
    inner = np.nonzero(left >= 0)[0]
    assert np.array_equal(lo[inner], np.minimum(lo[left[inner]],
                                                lo[right[inner]]))
    assert np.array_equal(hi[inner], np.maximum(hi[left[inner]],
                                                hi[right[inner]]))
    leaves = np.nonzero(left < 0)[0]
    slots = prims[leaf_row[leaves]]
    real = slots < n
    pad_lo = np.where(real[..., None], bmin[np.minimum(slots, n - 1)], np.inf)
    pad_hi = np.where(real[..., None], bmax[np.minimum(slots, n - 1)], -np.inf)
    assert np.array_equal(lo[leaves], pad_lo.min(axis=1))
    assert np.array_equal(hi[leaves], pad_hi.max(axis=1))


@pytest.mark.parametrize("case", sorted(BOX_SETS))
def test_sah_tree_fits_the_stack_and_is_recorded(case):
    """The tree's depth is within the traversal's stack, and
    ``LBVH_BUILDS`` records it, on the native route, as ``tree_stats``
    reads it."""
    tbvh.LBVH_BUILDS.reset()
    bvh, _, _, n = _sah_tree(case)
    stats = tbvh.tree_stats(bvh, n)
    assert stats["depth"] <= tbvh.STACK_DEPTH
    builds = tbvh.LBVH_BUILDS
    assert builds.routes == ["sah-native"] and builds.prims == [n]
    assert [builds.nodes[0], builds.leaves[0], builds.depth[0],
            builds.sah_ops[0]] == [stats[k] for k in (
                "nodes", "leaves", "depth", "sah_ops")]
    tbvh.LBVH_BUILDS.reset()


def _scan_winner(o, d, scene, block=64):
    """The closest triangle of every ray by testing all of them in index
    order (strict <, so the first of exact ties), in the traversal's
    direct triangle form -> (t, index)."""
    n = int(scene.chunks.num_tris.sum())
    idx = torch.arange(n)[None]
    ts, ids = [], []
    for s in range(0, o.shape[0], block):
        t = tbvh._triangle_t_one(o[s:s + block, None], d[s:s + block, None],
                                 scene, idx)
        best_t, best_i = torch.min(t, dim=1)
        ts.append(best_t)
        ids.append(torch.where(torch.isfinite(best_t), best_i, 0))
    return torch.cat(ts), torch.cat(ids)


def _sah_winner(o, d, scene):
    inf = torch.full((o.shape[0],), float("inf"))
    zero = torch.zeros(o.shape[0], dtype=torch.int64)
    return tbvh._traverse(
        o, d, scene.tri_bvh,
        lambda o_, d_, idx: tbvh._triangle_t_one(o_, d_, scene, idx),
        inf, zero)


def test_sah_closest_hit_equals_the_scan_on_the_mixed_scene():
    """Through the mixed scene's SAH tree, the plain traversal's closest
    triangle (t bit for bit and its index) is the scan's on 512 seeded
    rays."""
    ts = _mixed_scene(tscene, "tri", device="cpu")
    assert tbvh.tree_stats(ts.tri_bvh, int(ts.chunks.num_tris.sum()))[
        "nodes"] > 1
    o, d = (torch.from_numpy(x) for x in _rays(seed=2))
    t, i = _sah_winner(o, d, ts)
    t_scan, i_scan = _scan_winner(o, d, ts)
    assert 0.2 < float(torch.isfinite(t).double().mean()) < 0.95
    assert torch.equal(t.view(torch.int32), t_scan.view(torch.int32))
    assert torch.equal(i, i_scan)


def test_sah_closest_hit_equals_the_scan_on_the_dog():
    """The dog's scene at 48x27, 1 spp, 2 bounces: every ray the plain
    path traces through the SAH tree meets the triangle the scan of all
    33,902 meets, at the same t bit for bit."""
    scene, cam, cfg = t_load(DOG, overrides=dict(
        width=48, height=27, spp=1, max_bounce=2), device="cpu")
    assert tmk.geometry(scene, cfg) == "bvh"
    rays = []

    def tracing(o, d, sc):
        rays.append((o, d))
        return tbvh.closest_hit_bvh(o, d, sc)

    tmk.render_frames_plain(scene, cam, cfg, 7, intersect_fn=tracing)
    o = torch.cat([r[0] for r in rays])
    d = torch.cat([r[1] for r in rays])
    assert o.shape[0] >= 48 * 27 * 2
    t, i = _sah_winner(o, d, scene)
    t_scan, i_scan = _scan_winner(o, d, scene)
    assert 0.05 < float(torch.isfinite(t).double().mean()) < 0.95
    assert torch.equal(t.view(torch.int32), t_scan.view(torch.int32))
    assert torch.equal(i, i_scan)


def test_sah_tree_costs_less_than_the_lbvh_on_the_dog():
    """Over the dog's 33,902 triangle boxes: the SAH tree's surface-area
    cost (``tree_stats`` ``sah_ops``) is 145.04 FP32 operations a ray
    through the root (21,025 nodes, 19 levels), the LBVH's 239.56 (23,541
    nodes, 29 levels): the floor's 20 m boxes no longer widen the top of
    the tree."""
    bmin, bmax = dog_boxes()
    n = len(bmin)
    sah = tbvh.tree_stats(tbvh.build_sah_bvh(bmin, bmax, sentinel=n), n)
    lbvh = tbvh.tree_stats(tbvh.build_lbvh(bmin, bmax, sentinel=n), n)
    assert (sah["nodes"], sah["depth"]) == (21_025, 19)
    assert (lbvh["nodes"], lbvh["depth"]) == (23_541, 29)
    assert sah["sah_ops"] == pytest.approx(145.04, abs=0.01)
    assert lbvh["sah_ops"] == pytest.approx(239.56, abs=0.01)
