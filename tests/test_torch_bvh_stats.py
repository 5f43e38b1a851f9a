"""What ``accel/bvh.LBVH_BUILDS`` records of each build's tree
(``tree_stats``: nodes, leaves, depth, ``sah_ops``), and the
``scene.bvh_build`` span around each build in ``SceneBuilder.build``.
"""

import json

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu_torch.accel import bvh as tbvh
from ray_tracing_extended_tpu_torch.models.geometry import BVH
from ray_tracing_extended_tpu_torch.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def builds():
    tbvh.LBVH_BUILDS.reset()
    yield tbvh.LBVH_BUILDS
    tbvh.LBVH_BUILDS.reset()


def _recount(bvh: BVH):
    """(nodes, leaves, levels) by walking the tree from the root."""
    left, right = bvh.left.numpy(), bvh.right.numpy()
    seen, leaves, levels = 0, 0, 0
    frontier = [0]
    while frontier:
        levels += 1
        seen += len(frontier)
        nxt = []
        for k in frontier:
            if left[k] < 0:
                leaves += 1
            else:
                nxt += [int(left[k]), int(right[k])]
        frontier = nxt
    return seen, leaves, levels


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("n", [1, 5, 700])
def test_nodes_leaves_and_depth_are_the_returned_tree_s(builds, monkeypatch,
                                                        route, n):
    if route == "numpy":
        monkeypatch.setenv("RTE_NATIVE", "0")
    rng = np.random.default_rng(n)
    lo = rng.random((n, 3)).astype(np.float32) * 10
    hi = lo + rng.random((n, 3)).astype(np.float32)
    bvh = tbvh.build_lbvh(lo, hi, sentinel=n)
    assert builds.routes == [route]
    nodes, leaves, levels = _recount(bvh)
    assert nodes == bvh.left.shape[0]
    assert (builds.nodes, builds.leaves, builds.depth) == (
        [nodes], [leaves], [levels])
    assert leaves == bvh.leaf_prims.shape[0]
    assert builds.sah_ops[0] > 0


def test_sah_ops_is_the_area_weighted_sum_on_a_three_leaf_tree():
    """Root 0 -> (leaf 1, node 2); node 2 -> (leaf 3, leaf 4). Leaves hold
    2, 1 and 3 real triangles; the sentinel 9 pads the rest."""
    box = np.array([[0, 0, 0, 4, 2, 1],    # root: area 2 (8 + 2 + 4) = 28
                    [0, 0, 0, 1, 1, 1],    # area 6
                    [1, 0, 0, 4, 2, 1],    # area 2 (6 + 2 + 3) = 22
                    [1, 0, 0, 2, 2, 1],    # area 2 (2 + 2 + 1) = 10
                    [2, 0, 0, 4, 1, 0]],   # area 2 (2 + 0 + 0) = 4
                   np.float32)
    tree = BVH(bounds_min=torch.from_numpy(box[:, :3].copy()),
               bounds_max=torch.from_numpy(box[:, 3:].copy()),
               left=torch.tensor([1, -1, 3, -1, -1], dtype=torch.int32),
               right=torch.tensor([2, -1, 4, -1, -1], dtype=torch.int32),
               leaf_row=torch.tensor([-1, 0, -1, 1, 2], dtype=torch.int32),
               leaf_prims=torch.tensor([[0, 1, 9, 9], [2, 9, 9, 9],
                                        [3, 4, 5, 9]], dtype=torch.int32))
    stats = tbvh.tree_stats(tree, sentinel=9)
    expected = (12 * 28 + 24 * (28 + 22)
                + 34 * (2 * 6 + 1 * 10 + 3 * 4)) / 28
    assert stats == dict(nodes=5, leaves=3, depth=3,
                         sah_ops=pytest.approx(expected, rel=1e-12))


def test_a_tree_past_the_stack_is_refused():
    """A tree deeper than the traversal's stack is refused by
    ``tree_stats``, so by every build."""
    n = tbvh.STACK_DEPTH + 2
    # a spine of n levels: node i's left child is node i + 1, its right
    # a leaf of its own
    left = np.full(2 * n - 1, -1, np.int32)
    right = np.full(2 * n - 1, -1, np.int32)
    for i in range(n - 1):
        left[i], right[i] = i + 1, n + i
    chain = BVH(bounds_min=torch.zeros((2 * n - 1, 3)),
                bounds_max=torch.ones((2 * n - 1, 3)),
                left=torch.from_numpy(left), right=torch.from_numpy(right),
                leaf_row=torch.from_numpy(np.where(left < 0, 0, -1).astype(
                    np.int32)),
                leaf_prims=torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds the device traversal"):
        tbvh.tree_stats(chain, sentinel=1)


@pytest.mark.parametrize("build_bvh, spans", [("tri", 1), ("both", 2),
                                              (None, 0)])
def test_each_lbvh_build_opens_a_span(tmp_path, builds, build_bvh, spans):
    b = SceneBuilder()
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    for i in range(3):
        b.add_triangles(tri + i, np.tile([0, 0, 1], (1, 3, 1)), Material())
        b.add_sphere((i, 2, 0), 0.5, Material())
    with profiling.trace(str(tmp_path / "prof")):
        scene = b.build(build_bvh=build_bvh, device="cpu")
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e["name"] for e in events["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert names.count("scene.bvh_build") == spans
    assert len(builds.sah_ops) == spans
    assert (scene.tri_bvh is not None) == (build_bvh in ("tri", "both"))
    assert profiling.SCENE_BVH_BUILD == "scene.bvh_build"
