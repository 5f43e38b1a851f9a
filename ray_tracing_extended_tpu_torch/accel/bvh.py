"""The triangle BVH's builds (host) and the masked stack traversal
(PyTorch), the plain version of the CUDA kernel's BVH geometry
(``csrc/megakernel.cu`` ``closest_triangle_bvh``).

Two builds give the same ``BVH`` arrays: root 0, a node's two children
made together and the left subtree numbered first, fixed-width leaf rows
whose real slots come first and whose unused slots point at the scene's
first padding (never-hit) primitive, ``leaf_row`` -1 at internal nodes.

``build_sah_bvh``, the scene's triangle tree: top down, the split of
least ``A_left * N_left + A_right * N_right`` over 32 centroid bins on
each axis (the surface-area heuristic), halves by index where every
centroid falls in one bin, leaves of at most ``leaf_width``. A tree
deeper than the traversal's stack is not kept: the LBVH over the same
boxes is built instead.

``build_lbvh``, the LBVH that ``ray_tracing_extended_tpu/accel/bvh.py``
builds, copied line for line, so both packages build identical arrays:
primitive centroids are quantized to a 2^10 grid and interleaved into
30-bit Morton codes; primitives are sorted by code; the tree is built top
down by splitting each range at the highest differing Morton bit (median
fallback for equal codes). The scene's sphere tree (the plain path's) and
the SAH build's fallback.

Both run natively (``utils/native.py``, C++ through ctypes: the same
arrays bit for bit, 50-100x faster) unless ``RTE_NATIVE=0`` or no
``g++`` leaves them to NumPy; ``LBVH_BUILDS`` records each tree a build
keeps: its route, host seconds and the tree (``tree_stats``: nodes,
leaves, depth and its surface-area cost).

The traversal visits the nodes and primitives that the JAX package's
``_traverse`` visits, in its order, for each ray: at an internal node
slab-test both children against the best t so far and push the survivors,
the far one first, so the near one pops next; at a leaf test the slots
with a strict <; at most ``4 x nodes`` pops. It is the kernel's form of
it: the root is tested once, a node is pushed with its ``t_near`` and a
pop compares that with the best t instead of testing the node's slab
again, and a leaf's padding slots are skipped when the sentinel is known.
The JAX version steps every ray in lock step under masks; here only the
rays that still have nodes on their stack are stepped, which changes no
ray's result.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.geometry import BVH, Scene
from ..ops import vecmath as vm
from ..ops.intersect import (
    DET_EPS,
    INF,
    HitRecord,
    hit_record,
    ray_spheres_t,
    ray_triangles_t,
)
from ..utils import native

LEAF_WIDTH = 4
STACK_DEPTH = 48  # fits any split-balanced tree of < 2^47 prims
SAH_BINS = 32  # centroid bins on each axis of a binned-SAH split

# FP32 operations of a traversal's steps, for a tree's surface-area cost
# (``tree_stats``): the root's box test, both child boxes of an internal
# node, and one triangle test.
SAH_ROOT_OPS, SAH_NODE_OPS, SAH_TRIANGLE_OPS = 12, 24, 34

# Bytes the kernel reads for a traversal (csrc/megakernel.cu, its node
# table): the root's box and reference, both children's boxes and
# references an internal node (one 64-byte row), a leaf's row of slots,
# and a triangle's test row.
ROOT_BYTES, NODE_ROW_BYTES, LEAF_ROW_BYTES, PRIM_ROW_BYTES = 32, 64, 16, 48


# ------------------------------------------------------------- build -------
def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit integer coords (P, 3) -> 30-bit Morton codes."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (
        (expand(x[:, 0]) << 2) | (expand(x[:, 1]) << 1) | expand(x[:, 2])
    )


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """The tree's depth in levels (a lone root is 1), a level at a time."""
    levels = 0
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        levels += 1
        children = np.concatenate([left[frontier], right[frontier]])
        frontier = children[children >= 0]
    return levels


def _assert_traversable(left: np.ndarray, right: np.ndarray) -> int:
    """The traversal's stack is fixed (pushes clamp to its last slot), so a
    deeper tree would silently drop subtrees. Depth can exceed the Morton
    split's bound for long runs of equal codes, so the actual tree is
    measured -> its depth in levels (a lone root is 1)."""
    depth = _tree_depth(left, right)
    # traversal pushes at most one node per level beyond the current one
    if depth > STACK_DEPTH:
        raise ValueError(
            f"LBVH depth {depth} exceeds the device traversal "
            f"stack ({STACK_DEPTH}); rebuild with a larger leaf_width or "
            "raise STACK_DEPTH"
        )
    return depth


def _box_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    e = (np.asarray(bmax, np.float64) - np.asarray(bmin, np.float64))
    return 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0])


def tree_stats(bvh: BVH, sentinel: int) -> dict:
    """What tree a build gave: ``nodes``, ``leaves``, ``depth`` (levels, a
    lone root 1) and ``sah_ops``, its surface-area cost in FP32 operations
    for a ray through the root's box: ``SAH_ROOT_OPS`` for the root,
    ``SAH_NODE_OPS`` for each internal node (both child boxes) and
    ``SAH_TRIANGLE_OPS`` for each real primitive of a leaf (its slots
    below ``sentinel``), each term weighted by the node's box area over the
    root's (a root of no area weighs every node 1)."""
    left = bvh.left.numpy()
    right = bvh.right.numpy()
    leaf_row = bvh.leaf_row.numpy()
    area = _box_area(bvh.bounds_min.numpy(), bvh.bounds_max.numpy())
    weight = area / area[0] if area[0] > 0 else np.ones_like(area)
    real = (bvh.leaf_prims.numpy() < sentinel).sum(axis=1)
    internal = leaf_row < 0
    leaf_real = real[leaf_row[~internal]]
    sah = (SAH_ROOT_OPS * weight[0]
           + SAH_NODE_OPS * weight[internal].sum()
           + SAH_TRIANGLE_OPS * (weight[~internal] * leaf_real).sum())
    return dict(nodes=len(left), leaves=int((~internal).sum()),
                depth=_assert_traversable(left, right), sah_ops=float(sah))


def _clz64(x: int) -> int:
    return 64 - x.bit_length()


@dataclasses.dataclass
class LbvhBuilds:
    """Every tree a build keeps: its route (``"sah-native"`` or
    ``"sah-numpy"`` for ``build_sah_bvh``, ``"native"`` or ``"numpy"`` for
    ``build_lbvh``, the SAH build's fallback included), its primitives,
    its host seconds (the library's first-use compile not included) and
    the tree (``tree_stats``)."""

    routes: list = dataclasses.field(default_factory=list)
    prims: list = dataclasses.field(default_factory=list)
    seconds: list = dataclasses.field(default_factory=list)
    nodes: list = dataclasses.field(default_factory=list)
    leaves: list = dataclasses.field(default_factory=list)
    depth: list = dataclasses.field(default_factory=list)
    sah_ops: list = dataclasses.field(default_factory=list)

    def record(self, route: str, prims: int, seconds: float,
               stats: dict) -> None:
        self.routes.append(route)
        self.prims.append(prims)
        self.seconds.append(seconds)
        for key in ("nodes", "leaves", "depth", "sah_ops"):
            getattr(self, key).append(stats[key])

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            getattr(self, f.name).clear()


LBVH_BUILDS = LbvhBuilds()


def _bvh(bounds_min, bounds_max, left, right, leaf_row, leaf_prims,
         sentinel: int) -> BVH:
    # every slot the traversal gathers must be a real primitive index or
    # the sentinel: the kernel reads its rows unchecked
    if not (leaf_prims.min() >= 0 and leaf_prims.max() <= sentinel):
        raise ValueError(f"leaf_prims slot out of range [0, {sentinel}]")
    return BVH(
        bounds_min=torch.from_numpy(bounds_min),
        bounds_max=torch.from_numpy(bounds_max),
        left=torch.from_numpy(left),
        right=torch.from_numpy(right),
        leaf_row=torch.from_numpy(leaf_row),
        leaf_prims=torch.from_numpy(leaf_prims),
    )


def build_lbvh(
    prim_bmin: np.ndarray,
    prim_bmax: np.ndarray,
    sentinel: int,
    leaf_width: int = LEAF_WIDTH,
) -> BVH:
    """An LBVH over primitive AABBs, as CPU tensors. ``sentinel`` pads the
    fixed-width leaves: the index of a never-hit (padding) primitive of the
    scene's arrays. Built natively where ``utils/native`` has its library,
    else in NumPy: the same arrays."""
    prim_bmin = np.asarray(prim_bmin, np.float32)
    prim_bmax = np.asarray(prim_bmax, np.float32)
    p = prim_bmin.shape[0]
    lib = native.NATIVE.library()  # its first-use compile is not timed
    t0 = time.perf_counter()
    centroid = (prim_bmin + prim_bmax) * 0.5
    if lib is not None:
        codes = native.morton_codes(centroid)
        order = native.argsort_u64(codes)
        bvh = _bvh(*native.lbvh_build(prim_bmin, prim_bmax, order,
                                      codes[order], leaf_width, sentinel),
                   sentinel)
        seconds = time.perf_counter() - t0
        LBVH_BUILDS.record("native", p, seconds, tree_stats(bvh, sentinel))
        return bvh

    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    denom = np.where(hi > lo, hi - lo, 1.0)
    scale = np.where(hi > lo, 1023.0 / denom, 0.0)
    q = np.clip(((centroid - lo) * scale), 0, 1023).astype(np.uint32)
    codes = _morton3(q)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    codes = codes[order]

    # Top-down build over the sorted range, splitting at the highest
    # differing Morton bit (median fallback for equal codes).
    bounds_min, bounds_max = [], []
    left, right, leaf_row = [], [], []
    leaf_prims: list[np.ndarray] = []

    def new_node():
        bounds_min.append(None)
        bounds_max.append(None)
        left.append(-1)
        right.append(-1)
        leaf_row.append(-1)
        return len(left) - 1

    def node_bounds(node, s, e):
        idx = order[s:e]
        bounds_min[node] = prim_bmin[idx].min(axis=0)
        bounds_max[node] = prim_bmax[idx].max(axis=0)

    def split_pos(s, e):
        first, last = int(codes[s]), int(codes[e - 1])
        if first == last:
            return (s + e) // 2
        top_bit = 63 - _clz64(first ^ last)
        mask = 1 << top_bit
        # first index in [s, e) whose bit ``top_bit`` is set
        return s + int(np.searchsorted(codes[s:e] & mask, 1))

    # an explicit work stack, not recursion
    root = new_node()
    work = [(root, 0, p)]
    while work:
        node, s, e = work.pop()
        node_bounds(node, s, e)
        if e - s <= leaf_width:
            row = len(leaf_prims)
            slots = np.full(leaf_width, sentinel, np.int32)
            slots[: e - s] = order[s:e]
            leaf_prims.append(slots)
            leaf_row[node] = row
        else:
            m = split_pos(s, e)
            l_node = new_node()
            r_node = new_node()
            left[node] = l_node
            right[node] = r_node
            # the left subtree is numbered first
            work.append((r_node, m, e))
            work.append((l_node, s, m))

    bvh = _bvh(np.stack(bounds_min), np.stack(bounds_max),
               np.array(left, np.int32), np.array(right, np.int32),
               np.array(leaf_row, np.int32), np.stack(leaf_prims), sentinel)
    seconds = time.perf_counter() - t0
    LBVH_BUILDS.record("numpy", p, seconds, tree_stats(bvh, sentinel))
    return bvh


def _sah_split(cent: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """The binned-SAH split of one node's primitives (centroids ``cent``
    in float64, boxes ``bmin``, ``bmax`` in float32) -> a mask of those
    that go left, or None where every centroid falls in one bin.

    On each axis of positive centroid extent, centroid c falls in bin
    ``min(int((c - lo) / extent * SAH_BINS), SAH_BINS - 1)``; the split
    after bin i sends bins 0..i left. Its cost, in float64 and in this
    order, is ``area(left box) * n_left + area(right box) * n_right``;
    the least cost wins, the first axis and then the first bin on a tie."""
    n = len(cent)
    c_lo = cent.min(axis=0)
    extent = cent.max(axis=0) - c_lo
    best_cost, best = np.inf, None
    for axis in range(3):
        if not extent[axis] > 0.0:
            continue
        bins = np.minimum(
            ((cent[:, axis] - c_lo[axis]) / extent[axis] * SAH_BINS
             ).astype(np.int64), SAH_BINS - 1)
        lo = np.full((SAH_BINS, 3), np.inf, np.float32)
        hi = np.full((SAH_BINS, 3), -np.inf, np.float32)
        np.minimum.at(lo, bins, bmin)
        np.maximum.at(hi, bins, bmax)
        # the split after bin i: bins 0..i on the left, i+1.. on the right
        n_left = np.cumsum(np.bincount(bins, minlength=SAH_BINS))[:-1]
        n_right = n - n_left
        a_left = _box_area(np.minimum.accumulate(lo)[:-1],
                           np.maximum.accumulate(hi)[:-1])
        a_right = _box_area(np.minimum.accumulate(lo[::-1])[::-1][1:],
                            np.maximum.accumulate(hi[::-1])[::-1][1:])
        with np.errstate(invalid="ignore"):  # empty sides: inf * 0
            cost = np.where((n_left > 0) & (n_right > 0),
                            a_left * n_left + a_right * n_right, np.inf)
        i = int(np.argmin(cost))
        if cost[i] < best_cost:
            best_cost, best = cost[i], bins <= i
    return best


def _sah_build_numpy(prim_bmin, prim_bmax, leaf_width: int, sentinel: int):
    """``build_sah_bvh``'s arrays in NumPy: ``(bounds_min, bounds_max,
    left, right, leaf_row, leaf_prims)``."""
    cent = (prim_bmin.astype(np.float64) + prim_bmax.astype(np.float64)) * 0.5
    bounds_min, bounds_max = [], []
    left, right, leaf_row = [], [], []
    leaf_prims: list[np.ndarray] = []

    def new_node():
        bounds_min.append(None)
        bounds_max.append(None)
        left.append(-1)
        right.append(-1)
        leaf_row.append(-1)
        return len(left) - 1

    # an explicit work stack, not recursion; a node's primitives keep
    # their index order
    work = [(new_node(), np.arange(len(cent), dtype=np.int32))]
    while work:
        node, idx = work.pop()
        bounds_min[node] = prim_bmin[idx].min(axis=0)
        bounds_max[node] = prim_bmax[idx].max(axis=0)
        if len(idx) <= leaf_width:
            leaf_row[node] = len(leaf_prims)
            slots = np.full(leaf_width, sentinel, np.int32)
            slots[: len(idx)] = idx
            leaf_prims.append(slots)
            continue
        go_left = _sah_split(cent[idx], prim_bmin[idx], prim_bmax[idx])
        if go_left is None:  # halves by index
            go_left = np.arange(len(idx)) < len(idx) // 2
        l_node = new_node()
        r_node = new_node()
        left[node] = l_node
        right[node] = r_node
        # the left subtree is numbered first
        work.append((r_node, idx[~go_left]))
        work.append((l_node, idx[go_left]))
    return (np.stack(bounds_min), np.stack(bounds_max),
            np.array(left, np.int32), np.array(right, np.int32),
            np.array(leaf_row, np.int32), np.stack(leaf_prims))


def build_sah_bvh(
    prim_bmin: np.ndarray,
    prim_bmax: np.ndarray,
    sentinel: int,
    leaf_width: int = LEAF_WIDTH,
) -> BVH:
    """A binned-SAH BVH over primitive AABBs, as CPU tensors, in the
    arrays ``build_lbvh`` gives (``sentinel`` pads the leaves the same
    way). Built natively where ``utils/native`` has its library, else in
    NumPy: the same arrays. Where the tree is deeper than the traversal's
    stack (``STACK_DEPTH``) it is not kept: the LBVH over the same boxes
    is returned, and recorded as its own build."""
    prim_bmin = np.asarray(prim_bmin, np.float32)
    prim_bmax = np.asarray(prim_bmax, np.float32)
    p = prim_bmin.shape[0]
    lib = native.NATIVE.library()  # its first-use compile is not timed
    t0 = time.perf_counter()
    if lib is not None:
        route = "sah-native"
        arrays = native.sah_build(prim_bmin, prim_bmax, leaf_width, sentinel)
    else:
        route = "sah-numpy"
        arrays = _sah_build_numpy(prim_bmin, prim_bmax, leaf_width, sentinel)
    bvh = _bvh(*arrays, sentinel)
    seconds = time.perf_counter() - t0
    if _tree_depth(arrays[2], arrays[3]) > STACK_DEPTH:
        return build_lbvh(prim_bmin, prim_bmax, sentinel, leaf_width)
    LBVH_BUILDS.record(route, p, seconds, tree_stats(bvh, sentinel))
    return bvh


# ---------------------------------------------------------- traversal ------
def _slab(o, d_inv, bmin, bmax):
    """Per-ray slab test -> (t_near, t_far), (B, 3) -> (B,). NaN (a zero
    direction component with the origin on a face) propagates, and then
    every comparison of the visit rule fails."""
    t0 = (bmin - o) * d_inv
    t1 = (bmax - o) * d_inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_near, t_far


def _sphere_t_one(o, d, scene: Scene, idx):
    """Hit distance of gathered spheres ``idx`` for rays ``o``, ``d`` (any
    broadcast shapes; RaySphere semantics, RayTracing.shader:120-146), +inf
    on a miss."""
    c = scene.spheres.center[idx]
    r = scene.spheres.radius[idx]
    oc = o - c
    b = vm.dot(oc, d)
    cc = vm.dot(oc, oc) - r * r
    disc = b * b - cc
    t = -b - vm.sqrt(torch.clamp(disc, min=0.0))
    valid = (disc >= 0.0) & (t >= 0.0) & (r > 0.0)
    return torch.where(valid, t, INF)


def _triangle_t_one(o, d, scene: Scene, idx):
    """Hit distance of gathered triangles ``idx`` for rays ``o``, ``d`` (any
    broadcast shapes; RayTriangle semantics, RayTracing.shader:150-174, in
    the direct form), +inf on a miss."""
    tris = scene.triangles
    pa = tris.pos_a[idx]
    e_ab = tris.edge_ab[idx]
    e_ac = tris.edge_ac[idx]
    n = tris.n[idx]
    ao = o - pa
    dao = vm.cross(ao, d)
    det = -vm.dot(d, n)
    t_det = vm.dot(ao, n)
    u_det = vm.dot(e_ac, dao)
    v_det = -vm.dot(e_ab, dao)
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


def _traverse(o, d, bvh: BVH, prim_t_fn, best_t, best_idx, counts=None,
              sentinel=None):
    """Closest primitive through ``bvh`` for every ray: ``prim_t_fn(o, d,
    idx)`` gives the t of primitives ``idx`` (B, W) for rays (B, 1, 3).
    Returns ``(best_t, best_idx)`` updated where a strictly nearer
    primitive was found.

    The kernel's traversal: the root is slab-tested once; a node is pushed
    with the ``t_near`` of the slab test its parent made, and a pop drops
    it by comparing that ``t_near`` with the best t so far, with no second
    slab test (a pushed node passed ``t_far >= 0 and t_near <= min(t_far,
    best)``, ``best`` only falls, and a NaN slab is never pushed, so this
    is the JAX package's test at the pop). With ``sentinel``, the leaves'
    padding index, only a leaf's real slots are tested (the build puts
    them first; the sentinel never hits, so the result is the same).

    ``counts``, a dict, if given, gains: ``"slabs"``, the root's test a
    ray and both children's at every internal node visited; ``"prims"``,
    the real primitives tested (every slot without ``sentinel``);
    ``"pops"``, every stack entry popped and every failed root test (in
    place of the root's pop), of them ``"pop_rejects"`` those rejected (the
    root by its slab test, an entry by its ``t_near``); ``"internal"`` and
    ``"leaves"``, the nodes visited; and ``"fetched_bytes"``, what the
    kernel reads for it by its node table's layout
    (``kernels/megakernel.bvh_node_table``): the root's ``ROOT_BYTES`` a
    ray, ``NODE_ROW_BYTES`` an internal node (both children's boxes),
    ``LEAF_ROW_BYTES`` a leaf and ``PRIM_ROW_BYTES`` a primitive tested."""
    b = o.shape[0]
    dev = o.device
    d_inv = 1.0 / d
    leaf_width = bvh.leaf_prims.shape[1]
    n_nodes = bvh.left.shape[0]
    best_t, best_idx = best_t.clone(), best_idx.clone()
    stack = torch.zeros((b, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_tn = torch.zeros((b, STACK_DEPTH), dtype=torch.float32, device=dev)
    # the root's slab test, in place of its pop: a ray that passes it
    # starts with the root on its stack
    t_near, t_far = _slab(o, d_inv, bvh.bounds_min[0], bvh.bounds_max[0])
    root = (t_far >= 0.0) & (t_near <= torch.minimum(t_far, best_t))
    stack_tn[:, 0] = t_near
    ptr = root.long()
    lanes = root.nonzero().squeeze(1)
    # a failed root test takes the place of the root's pop; the real
    # primitives are summed on the device, read once at the end
    pops = rejects = b - lanes.numel()
    internal = leaves = 0
    prims = torch.zeros((), dtype=torch.int64, device=dev)
    # the root's test was the first of at most 4 x nodes pops
    for _ in range(4 * n_nodes - 1):
        if lanes.numel() == 0:
            break
        p = ptr[lanes] - 1
        node = stack[lanes, p]
        tn = stack_tn[lanes, p]
        ptr[lanes] = p
        o_l, d_l, inv_l = o[lanes], d[lanes], d_inv[lanes]
        bt = best_t[lanes]
        visit = tn <= bt
        row = bvh.leaf_row[node].long()
        is_leaf = row >= 0

        # leaves: the real slots, in order, strictly nearer wins
        lf = (visit & is_leaf).nonzero().squeeze(1)
        if lf.numel():
            slots = bvh.leaf_prims[row[lf]].long()  # (n, leaf_width)
            t_all = prim_t_fn(o_l[lf, None], d_l[lf, None], slots)
            if sentinel is not None:
                real = slots < sentinel
                t_all = torch.where(real, t_all, INF)
                prims += real.sum()
            else:
                prims += slots.numel()
            bt_f, bi_f = bt[lf], best_idx[lanes[lf]]
            for j in range(leaf_width):
                better = t_all[:, j] < bt_f
                bt_f = torch.where(better, t_all[:, j], bt_f)
                bi_f = torch.where(better, slots[:, j], bi_f)
            best_t[lanes[lf]] = bt_f
            best_idx[lanes[lf]] = bi_f

        # internal nodes: slab-test both children, push the survivors with
        # their t_near, far first (the near one pops next)
        it = (visit & ~is_leaf).nonzero().squeeze(1)
        if it.numel():
            li = lanes[it]
            o_i, inv_i, bt_i = o_l[it], inv_l[it], bt[it]
            l_node = bvh.left[node[it]].long()
            r_node = bvh.right[node[it]].long()
            tn_l, tf_l = _slab(o_i, inv_i, bvh.bounds_min[l_node],
                               bvh.bounds_max[l_node])
            tn_r, tf_r = _slab(o_i, inv_i, bvh.bounds_min[r_node],
                               bvh.bounds_max[r_node])
            hit_l = (tf_l >= 0.0) & (tn_l <= torch.minimum(tf_l, bt_i))
            hit_r = (tf_r >= 0.0) & (tn_r <= torch.minimum(tf_r, bt_i))
            both = hit_l & hit_r
            l_is_near = tn_l <= tn_r
            near = torch.where(l_is_near, l_node, r_node)
            far = torch.where(l_is_near, r_node, l_node)
            near_tn = torch.where(l_is_near, tn_l, tn_r)
            far_tn = torch.where(l_is_near, tn_r, tn_l)
            first = torch.where(both, far, torch.where(hit_l, l_node, r_node))
            first_tn = torch.where(both, far_tn, torch.where(hit_l, tn_l, tn_r))
            any_push = hit_l | hit_r
            p_i = ptr[li]
            p0 = torch.clamp(p_i, max=STACK_DEPTH - 1)
            p1 = torch.clamp(p_i + 1, max=STACK_DEPTH - 1)
            stack[li, p0] = torch.where(any_push, first, stack[li, p0])
            stack_tn[li, p0] = torch.where(any_push, first_tn, stack_tn[li, p0])
            stack[li, p1] = torch.where(both, near, stack[li, p1])
            stack_tn[li, p1] = torch.where(both, near_tn, stack_tn[li, p1])
            ptr[li] = p_i + any_push.long() + both.long()
        pops += lanes.numel()
        internal += it.numel()
        leaves += lf.numel()
        rejects += lanes.numel() - it.numel() - lf.numel()
        lanes = lanes[ptr[lanes] > 0]
    if counts is not None:
        n_prims = int(prims)
        for key, n in (
            ("slabs", b + 2 * internal), ("prims", n_prims), ("pops", pops),
            ("pop_rejects", rejects), ("internal", internal),
            ("leaves", leaves),
            ("fetched_bytes", ROOT_BYTES * b + NODE_ROW_BYTES * internal
             + LEAF_ROW_BYTES * leaves + PRIM_ROW_BYTES * n_prims),
        ):
            counts[key] = counts.get(key, 0) + n
    return best_t, best_idx


def closest_hit_bvh(o, d, scene: Scene, sphere_bvh: bool = True,
                    counts=None) -> HitRecord:
    """Closest hit through the scene's BVHs where present (triangles and,
    with ``sphere_bvh``, spheres), scanning the primitive type without one:
    ``closest_hit_bruteforce``'s result, except which of two exactly tied
    primitives of one type wins (the first in traversal order). A sphere
    wins an exact tie with a triangle, as in the reference's scan.
    ``counts`` gathers the tests the triangle BVH's traversal needs
    (``_traverse``)."""
    b = o.shape[0]
    dev = o.device
    s = scene.spheres.count
    inf = torch.full((b,), INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((b,), dtype=torch.int64, device=dev)

    if sphere_bvh and scene.sphere_bvh is not None:
        t_s, i_s = _traverse(
            o, d, scene.sphere_bvh,
            lambda o_, d_, idx: _sphere_t_one(o_, d_, scene, idx), inf, zero,
        )
    else:
        t_s, i_s = torch.min(ray_spheres_t(o, d, scene.spheres), dim=1)
    better = t_s < inf
    best_t = torch.where(better, t_s, inf)
    best_enc = torch.where(better, i_s, zero)

    if scene.tri_bvh is not None:
        # the leaves' padding index is the first padding triangle: the
        # number of real ones, which the chunks hold
        sentinel = None if counts is None else int(scene.chunks.num_tris.sum())
        t_t, i_t = _traverse(
            o, d, scene.tri_bvh,
            lambda o_, d_, idx: _triangle_t_one(o_, d_, scene, idx), inf, zero,
            counts, sentinel,
        )
    else:
        t_t, i_t = torch.min(ray_triangles_t(o, d, scene.triangles), dim=1)
    # strict <: spheres win exact ties (the reference's scan order)
    better = t_t < best_t
    best_t = torch.where(better, t_t, best_t)
    best_enc = torch.where(better, s + i_t, best_enc)

    return hit_record(o, d, scene, best_t, best_enc)
