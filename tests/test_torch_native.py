"""The port's native BVH builds (``utils/native.py``, ``csrc/geometry.cpp``)
against their NumPy builds: the LBVH also against the JAX package's
``build_lbvh`` (Morton codes, the u64 argsort and every BVH array bit for
bit, on random boxes, on degenerate extents (a flat axis, all centroids
equal) and on the 70,016 triangles of ``mesh_scene``), the binned-SAH
build on random boxes, the knot, the dog, equal centroids and a few huge
boxes among small ones, and its fallback to the LBVH; the route each build
took; a compiler that fails raises.
"""

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.accel.bvh import build_lbvh as j_build_lbvh
from ray_tracing_extended_tpu_torch.accel import bvh as tbvh
from ray_tracing_extended_tpu_torch.models.presets import mesh_scene
from ray_tracing_extended_tpu_torch.utils import native
from scene_bvhs import (
    BOX_SETS,
    assert_same_bvh,
    dog_boxes,
    record_tri_boxes,
)


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
def native_route():
    """The native route (a g++ is on this machine's PATH; RTE_NATIVE unset)
    and a fresh build record."""
    if not native.available():
        pytest.fail("the native LBVH library did not load: no g++ on PATH, "
                    "or RTE_NATIVE=0")
    tbvh.LBVH_BUILDS.reset()
    yield
    tbvh.LBVH_BUILDS.reset()


def _numpy_build(monkeypatch, bmin, bmax, sentinel, build=None):
    monkeypatch.setenv("RTE_NATIVE", "0")
    try:
        return (build or tbvh.build_lbvh)(bmin, bmax, sentinel=sentinel)
    finally:
        monkeypatch.delenv("RTE_NATIVE")


def _boxes(case: str, n: int = 3000):
    rs = np.random.RandomState(1)
    bmin = rs.uniform(-10, 10, (n, 3)).astype(np.float32)
    bmax = bmin + rs.uniform(0.01, 1, (n, 3)).astype(np.float32)
    if case == "flat_axis":  # every centroid on one plane: a zero extent
        bmin[:, 1] = 0.25
        bmax[:, 1] = 0.75
    elif case == "equal_centroids":  # every code equal: median splits only
        bmin[:] = bmin[0]
        bmax[:] = bmax[0]
    return bmin, bmax


@pytest.mark.parametrize("case", ["random", "flat_axis", "equal_centroids"])
def test_morton_and_argsort_match_numpy(native_route, case):
    bmin, bmax = _boxes(case)
    c = (bmin + bmax) * 0.5
    codes = native.morton_codes(c)
    # the NumPy build's quantisation (accel/bvh.py)
    lo, hi = c.min(0), c.max(0)
    denom = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip((c - lo) * np.where(hi > lo, 1023.0 / denom, 0.0), 0, 1023
                ).astype(np.uint32)
    ref = tbvh._morton3(q)
    assert codes.dtype == np.uint64 and np.array_equal(codes, ref)
    order = native.argsort_u64(codes)
    assert order.dtype == np.int32
    assert np.array_equal(order, np.argsort(codes, kind="stable"))


@pytest.mark.parametrize("case", ["random", "flat_axis", "equal_centroids"])
def test_lbvh_native_matches_numpy_and_jax(native_route, monkeypatch, case):
    bmin, bmax = _boxes(case)
    n = len(bmin)
    built = tbvh.build_lbvh(bmin, bmax, sentinel=n)
    assert tbvh.LBVH_BUILDS.routes == ["native"]
    plain = _numpy_build(monkeypatch, bmin, bmax, n)
    assert tbvh.LBVH_BUILDS.routes == ["native", "numpy"]
    assert tbvh.LBVH_BUILDS.prims == [n, n]
    assert_same_bvh(built, plain)
    assert_same_bvh(built, j_build_lbvh(bmin, bmax, sentinel=n))


def test_mesh_scene_lbvh_native_matches_numpy_and_jax(native_route,
                                                      monkeypatch):
    """The 70,016-triangle knot: ``mesh_scene`` builds its SAH tree
    natively, equal to the NumPy SAH build of the same boxes (those
    ``SceneBuilder.build`` passed); over them the native LBVH equals the
    NumPy build and the JAX package's."""
    calls = record_tri_boxes(monkeypatch)
    scene, _, _ = mesh_scene(device="cpu")
    (bmin, bmax, n), = calls
    assert n == 70016 and bmin.shape == (n, 3)
    assert tbvh.LBVH_BUILDS.routes == ["sah-native"]
    assert tbvh.LBVH_BUILDS.prims == [n]
    assert_same_bvh(scene.tri_bvh, _numpy_build(monkeypatch, bmin, bmax, n,
                                                 tbvh.build_sah_bvh))
    built = tbvh.build_lbvh(bmin, bmax, sentinel=n)
    assert_same_bvh(built, _numpy_build(monkeypatch, bmin, bmax, n))
    assert_same_bvh(built, j_build_lbvh(bmin, bmax, sentinel=n))
    assert tbvh.LBVH_BUILDS.routes == ["sah-native", "sah-numpy", "native",
                                       "numpy"]


def test_native_build_speed(native_route):
    """70,000 boxes well under the JAX test's limit of 2 s."""
    rs = np.random.RandomState(2)
    n = 70000
    bmin = rs.uniform(-10, 10, (n, 3)).astype(np.float32)
    bmax = bmin + 0.05
    built = tbvh.build_lbvh(bmin, bmax, sentinel=n)
    assert built.left.shape[0] > n / 4
    assert tbvh.LBVH_BUILDS.routes == ["native"]
    assert tbvh.LBVH_BUILDS.seconds[0] < 2.0, tbvh.LBVH_BUILDS


def test_rte_native_0_takes_numpy(native_route, monkeypatch):
    bmin, bmax = _boxes("random", 500)
    monkeypatch.setenv("RTE_NATIVE", "0")
    assert not native.available()
    assert native.morton_codes((bmin + bmax) / 2) is None
    tbvh.build_lbvh(bmin, bmax, sentinel=500)
    assert tbvh.LBVH_BUILDS.routes == ["numpy"]
    assert tbvh.LBVH_BUILDS.seconds[0] > 0


def test_missing_compiler_takes_numpy(native_route, monkeypatch):
    monkeypatch.setattr(native, "NATIVE",
                        native.NativeGeometry(compiler="no-such-compiler-g++"))
    bmin, bmax = _boxes("random", 500)
    tbvh.build_lbvh(bmin, bmax, sentinel=500)
    assert tbvh.LBVH_BUILDS.routes == ["numpy"]


def test_failing_compiler_raises(native_route, monkeypatch, tmp_path):
    """A compiler that is there and fails raises with its output: no
    silent NumPy build."""
    broken = tmp_path / "geometry.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "NATIVE", native.NativeGeometry(source=broken))
    bmin, bmax = _boxes("random", 500)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed .*error"):
        tbvh.build_lbvh(bmin, bmax, sentinel=500)
    assert tbvh.LBVH_BUILDS.routes == []


# ---- the binned-SAH build ---------------------------------------------------

@pytest.mark.parametrize("case", sorted(BOX_SETS))
def test_sah_native_matches_numpy(native_route, monkeypatch, case):
    """The native SAH build and the NumPy one: every array bit for bit
    (the float32 boxes by their bits), each build recorded on its
    route."""
    bmin, bmax = BOX_SETS[case]()
    n = len(bmin)
    built = tbvh.build_sah_bvh(bmin, bmax, sentinel=n)
    plain = _numpy_build(monkeypatch, bmin, bmax, n, tbvh.build_sah_bvh)
    assert tbvh.LBVH_BUILDS.routes == ["sah-native", "sah-numpy"]
    assert tbvh.LBVH_BUILDS.prims == [n, n]
    assert_same_bvh(built, plain)
    for f in ("bounds_min", "bounds_max"):
        assert torch.equal(getattr(built, f).view(torch.int32),
                           getattr(plain, f).view(torch.int32)), f


def _deep_boxes(n=126):
    """Boxes at x = 2^k: each SAH split peels off the farthest few, so the
    tree is 28 levels deep; the LBVH's Morton grid puts most in one cell
    and splits them by index, 16 levels."""
    x = np.float32(2.0) ** np.arange(n, dtype=np.float32)
    bmin = np.stack([x, np.zeros(n), np.zeros(n)], axis=1).astype(np.float32)
    return bmin, bmin + np.float32(0.5)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_sah_tree_past_the_stack_falls_back_to_the_lbvh(native_route,
                                                        monkeypatch, route):
    """Where the SAH tree would be deeper than the traversal's stack, the
    build keeps the LBVH over the same boxes, and records that build, on
    its route, alone (the stack set to 20 levels here: the SAH tree has
    28, the LBVH 16)."""
    bmin, bmax = _deep_boxes()
    n = len(bmin)
    assert tbvh.tree_stats(tbvh.build_sah_bvh(bmin, bmax, sentinel=n),
                           n)["depth"] == 28
    monkeypatch.setattr(tbvh, "STACK_DEPTH", 20)
    if route == "numpy":
        monkeypatch.setenv("RTE_NATIVE", "0")
    tbvh.LBVH_BUILDS.reset()
    kept = tbvh.build_sah_bvh(bmin, bmax, sentinel=n)
    assert tbvh.LBVH_BUILDS.routes == [route]
    assert tbvh.LBVH_BUILDS.depth == [16]
    assert_same_bvh(kept, tbvh.build_lbvh(bmin, bmax, sentinel=n))


def test_dog_sah_build_speed(native_route):
    """The dog's 33,902 boxes build natively in well under the scene's
    budget of 0.2 s (0.06 s on one core of an x86-64 host, where the
    NumPy route takes 3.2 s)."""
    bmin, bmax = dog_boxes()
    tbvh.build_sah_bvh(bmin, bmax, sentinel=len(bmin))
    assert tbvh.LBVH_BUILDS.routes == ["sah-native"]
    assert tbvh.LBVH_BUILDS.seconds[0] < 0.5, tbvh.LBVH_BUILDS
