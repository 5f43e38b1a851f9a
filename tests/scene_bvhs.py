"""A scene's triangle BVH held to the JAX package's over the same boxes.

The port's ``SceneBuilder.build`` gives its triangles a binned-SAH tree
(``accel/bvh.build_sah_bvh``), the JAX package's an LBVH. A test records
the boxes the port's build passed, then holds the port's ``build_lbvh``
over them to the JAX package's tree bit for bit, and the scene's tree to
``build_sah_bvh`` over them:

    boxes = record_tri_boxes(monkeypatch)
    ts = tscene.SceneBuilder()...build(build_bvh="tri", device="cpu")
    assert_scene_tri_bvh(ts.tri_bvh, js.tri_bvh, boxes)
"""

import pathlib

import numpy as np

from ray_tracing_extended_tpu_torch.accel import bvh as tbvh
from ray_tracing_extended_tpu_torch.models import scene as tscene
from ray_tracing_extended_tpu_torch.scene import procedural as tproc

DOG_NPZ = (pathlib.Path(__file__).resolve().parent.parent / "benchmark"
           / "scenes" / "dmc-dog-skin.npz")

FIELDS = ("bounds_min", "bounds_max", "left", "right", "leaf_row",
          "leaf_prims")


def assert_same_bvh(a, b):
    """Two BVHs (port tensors or JAX arrays) equal in dtype, shape and
    value."""
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def record_tri_boxes(monkeypatch) -> list:
    """-> a list that gains ``(bmin, bmax, sentinel)`` at each triangle
    BVH build of the port's ``SceneBuilder.build``."""
    calls = []
    build = tscene.build_sah_bvh

    def recording(bmin, bmax, sentinel):
        calls.append((np.array(bmin), np.array(bmax), sentinel))
        return build(bmin, bmax, sentinel=sentinel)

    monkeypatch.setattr(tscene, "build_sah_bvh", recording)
    return calls


def assert_scene_tri_bvh(port_bvh, jax_bvh, calls) -> None:
    """Over the boxes of the last recorded build: the port's LBVH is the
    JAX package's tree, and the port's scene holds the SAH tree."""
    bmin, bmax, sentinel = calls[-1]
    assert_same_bvh(tbvh.build_lbvh(bmin, bmax, sentinel=sentinel), jax_bvh)
    assert_same_bvh(port_bvh, tbvh.build_sah_bvh(bmin, bmax,
                                                 sentinel=sentinel))


# ---- box sets for the builds ----------------------------------------------

def dog_boxes():
    """The boxes of the dog's 33,902 triangles (skin, then floor), in the
    order its scene holds them."""
    data = np.load(DOG_NPZ)
    pos = np.concatenate([data["g000_pos"], data["g001_pos"]])
    return pos.min(axis=1), pos.max(axis=1)


def trefoil_boxes():
    v, f = tproc.trefoil_knot_mesh(4000)
    tri = v[f]
    return tri.min(axis=1), tri.max(axis=1)


def random_boxes(n=3000):
    rs = np.random.RandomState(1)
    bmin = rs.uniform(-10, 10, (n, 3)).astype(np.float32)
    return bmin, bmin + rs.uniform(0.01, 1, (n, 3)).astype(np.float32)


def equal_centroid_boxes(n=300):
    """Every box the same: every centroid in one bin, halves by index."""
    bmin, bmax = random_boxes(n)
    return np.repeat(bmin[:1], n, axis=0), np.repeat(bmax[:1], n, axis=0)


def huge_among_small_boxes(n=2000):
    """Small boxes in a 1.2 m cluster, and a few 20 m ones around it, as
    the dog's floor around its skin."""
    rs = np.random.RandomState(7)
    bmin = rs.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    bmax = bmin + rs.uniform(0.001, 0.03, (n, 3)).astype(np.float32)
    big = np.float32([[-10, -0.01, -10, 10, 0.0, 10],
                      [-10, -0.01, -10, 10, 0.0, 0.0],
                      [-10, -10, 3.0, 10, 10, 3.01],
                      [-0.5, -20, -0.5, 0.5, 20, 0.5]])
    order = rs.permutation(n + len(big))  # the big ones anywhere
    return (np.concatenate([bmin, big[:, :3]])[order],
            np.concatenate([bmax, big[:, 3:]])[order])


BOX_SETS = dict(random=random_boxes, trefoil=trefoil_boxes, dog=dog_boxes,
                equal_centroids=equal_centroid_boxes,
                huge_among_small=huge_among_small_boxes)
