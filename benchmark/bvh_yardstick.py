"""A fixed BVH over a scene's triangles, and the least work a closest hit
through it needs: the yardstick of ``metrics/bvh_roofline.py``.

It imports torch, numpy and the benchmark's ``reference`` only, nothing of
the program, so the count is the same whatever tree the program builds. The
tree is built top down with the surface-area heuristic binned on the
triangles' centroids: 32 bins on each axis, the split of least ``A_left *
N_left + A_right * N_right`` over the three axes, the triangles split by
index in halves where every centroid falls in one bin, and every node of at
most ``LEAF`` triangles a leaf.

A segment's work, given its final distance ``t*`` from the reference: 12
FP32 operations for the root's box test, 24 for each internal node whose
box the segment enters within ``[0, t*]`` (both child boxes tested), and
34 for each triangle of each leaf so entered; a node counts only when every
box above it was entered, as in an ideal traversal that visits nothing it
can skip. ``sah_ops`` is the tree's surface-area cost in the same units,
the program's ``LBVH_BUILDS`` ``sah_ops`` rule. A scene's spheres are not
counted (the cells that read this have none).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import reference

OPS_ROOT, OPS_NODE, OPS_TRIANGLE = reference.OPS_BOX, 2 * reference.OPS_BOX, \
    reference.OPS_TRIANGLE
BINS = 32
LEAF = 4
INF = float("inf")


@dataclasses.dataclass
class Tree:
    """Nodes in build order, the root first: each node's box, its children
    (-1 at a leaf) and its triangles (a leaf's count, 0 at an internal
    node)."""

    lo: np.ndarray  # (N, 3) f32
    hi: np.ndarray  # (N, 3) f32
    left: np.ndarray  # (N,) int64
    right: np.ndarray  # (N,) int64
    count: np.ndarray  # (N,) int64

    def area(self) -> np.ndarray:
        return _box_area(self.lo.astype(np.float64),
                         self.hi.astype(np.float64))

    def sah_ops(self) -> float:
        """12 for the root, 24 an internal node and 34 a leaf's triangle,
        each weighted by the node's box area over the root's."""
        a = self.area()
        w = a / a[0] if a[0] > 0 else np.ones_like(a)
        internal = self.left >= 0
        leaves = (w[~internal] * self.count[~internal]).sum()
        return float(OPS_ROOT * w[0] + OPS_NODE * w[internal].sum()
                     + OPS_TRIANGLE * leaves)


def _box_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                  + e[..., 2] * e[..., 0])


def _split(cent, lo, hi):
    """-> a boolean mask of the triangles that go left, or None where no
    binned split separates them."""
    c_lo, c_hi = cent.min(0), cent.max(0)
    ext = c_hi - c_lo
    best, best_cost = None, INF
    for axis in range(3):
        if ext[axis] <= 0.0:
            continue
        b = np.minimum(((cent[:, axis] - c_lo[axis]) / ext[axis]
                        * BINS).astype(np.int64), BINS - 1)
        n = np.bincount(b, minlength=BINS)
        b_lo = np.full((BINS, 3), INF)
        b_hi = np.full((BINS, 3), -INF)
        np.minimum.at(b_lo, b, lo)
        np.maximum.at(b_hi, b, hi)
        # left of the split after bin i holds bins 0..i
        l_lo = np.minimum.accumulate(b_lo, axis=0)[:-1]
        l_hi = np.maximum.accumulate(b_hi, axis=0)[:-1]
        r_lo = np.minimum.accumulate(b_lo[::-1], axis=0)[::-1][1:]
        r_hi = np.maximum.accumulate(b_hi[::-1], axis=0)[::-1][1:]
        n_l = np.cumsum(n)[:-1]
        n_r = len(cent) - n_l
        ok = (n_l > 0) & (n_r > 0)
        if not ok.any():
            continue
        cost = np.where(ok, _box_area(l_lo, l_hi) * n_l
                        + _box_area(r_lo, r_hi) * n_r, INF)
        i = int(np.argmin(cost))
        if cost[i] < best_cost:
            best_cost, best = cost[i], b <= i
    return best


def build(tri_pos: np.ndarray) -> Tree:
    """The yardstick's tree over triangles ``tri_pos`` (T, 3, 3)."""
    tri_pos = np.asarray(tri_pos, np.float64)
    lo_t, hi_t = tri_pos.min(1), tri_pos.max(1)
    cent = (lo_t + hi_t) * 0.5
    lo, hi, left, right, count = [], [], [], [], []

    def node(idx):
        lo.append(lo_t[idx].min(0))
        hi.append(hi_t[idx].max(0))
        left.append(-1)
        right.append(-1)
        count.append(0)
        return len(lo) - 1

    work = [(node(np.arange(len(tri_pos))), np.arange(len(tri_pos)))]
    while work:
        k, idx = work.pop()
        if len(idx) <= LEAF:
            count[k] = len(idx)
            continue
        go_left = _split(cent[idx], lo_t[idx], hi_t[idx])
        if go_left is None:
            go_left = np.arange(len(idx)) < len(idx) // 2
        l_idx, r_idx = idx[go_left], idx[~go_left]
        left[k], right[k] = node(l_idx), node(r_idx)
        work.append((right[k], r_idx))
        work.append((left[k], l_idx))
    return Tree(lo=np.array(lo, np.float32), hi=np.array(hi, np.float32),
                left=np.array(left, np.int64), right=np.array(right, np.int64),
                count=np.array(count, np.int64))


class Counter:
    """A tree on a device, counting segments' work (``ops``)."""

    def __init__(self, tree: Tree, device):
        dev = torch.device(device)
        self.lo = torch.as_tensor(tree.lo, device=dev)
        self.hi = torch.as_tensor(tree.hi, device=dev)
        self.left = torch.as_tensor(tree.left, device=dev)
        self.right = torch.as_tensor(tree.right, device=dev)
        self.leaf_ops = torch.as_tensor(tree.count * OPS_TRIANGLE,
                                        dtype=torch.float64, device=dev)

    def entered(self, o, inv, node, bound):
        """The reference's slab rule (``Tracer._entered``), a pair a row."""
        t0 = (self.lo[node] - o) * inv
        t1 = (self.hi[node] - o) * inv
        free = torch.isnan(t0) | torch.isnan(t1)
        near = torch.where(free, -INF, torch.minimum(t0, t1)).amax(-1)
        far = torch.where(free, INF, torch.maximum(t0, t1)).amin(-1)
        return (near <= far) & (far >= 0.0) & (near <= bound)

    def ops(self, o, d, best_t):
        """-> (B,) float64: each segment's work through the tree."""
        o32, bound = o.float(), best_t.float()
        inv = 1.0 / d.float()
        n = o.shape[0]
        out = torch.full((n,), float(OPS_ROOT), dtype=torch.float64,
                         device=o.device)
        ray = torch.arange(n, device=o.device)
        node = torch.zeros(n, dtype=torch.int64, device=o.device)
        while ray.numel():
            hit = self.entered(o32[ray], inv[ray], node, bound[ray])
            ray, node = ray[hit], node[hit]
            inner = self.left[node] >= 0
            out.index_add_(0, ray, torch.where(inner, float(OPS_NODE),
                                               self.leaf_ops[node]))
            ray, node = ray[inner], node[inner]
            ray = torch.cat([ray, ray])
            node = torch.cat([self.left[node], self.right[node]])
        return out


class YardstickTracer(reference.Tracer):
    """The reference tracer whose ``ops_per_segment`` is the yardstick's
    count through ``build``'s tree over the scene's triangles."""

    def _count_tables(self, scene) -> None:
        self.tree = build(scene.tri_pos)
        self.counter = Counter(self.tree, self.dev)

    def ops_per_segment(self, o, d, best_t):
        return self.counter.ops(o, d, best_t)
