"""The port's sphere clustering (``kernels/pack.py``) against the JAX
package's ``pack_scene`` on the same scenes, and the kernel's tables built
from it.

The scenes come from the JAX presets or from NumPy with a fixed seed; both
packages pack the same arrays. Everything here is integer or exact f32
bookkeeping on the host, so the tables are held equal, not close.
"""

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.kernels.pack import pack_scene
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.models.scene import SceneBuilder as JBuilder
from ray_tracing_extended_tpu.models.scene import Material as JMaterial
from ray_tracing_extended_tpu_torch.interop import scene_from_arrays
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.kernels.pack import SUB, pack_spheres


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_rtiow():
    """A small RTIOW-like scene from a seed: a huge ground sphere, one big
    hero and 70 small spheres on a jittered grid."""
    rs = np.random.RandomState(0)
    b = JBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, JMaterial())
    b.add_sphere((0.0, 1.0, 0.0), 1.0, JMaterial())
    for i in range(70):
        x, z = i % 10 - 5 + 0.8 * rs.rand(), i // 10 - 3 + 0.8 * rs.rand()
        b.add_sphere((x, 0.2, z), 0.2, JMaterial())
    return b.build()


def _scene(name):
    if name == "small_rtiow":
        return _small_rtiow()
    return getattr(jpresets, name)(width=8, height=8)[0]


SCENES = ["three_sphere_scene", "cornell_box_scene", "small_rtiow",
          "rtiow_final_scene"]


@pytest.mark.parametrize("name", SCENES)
def test_pack_matches_jax(name):
    js = _scene(name)
    want = pack_scene(js)
    centers = np.asarray(js.spheres.center)
    radii = np.asarray(js.spheres.radius)
    got = pack_spheres(centers, radii)
    n = got.n_sphere_subs
    assert n == want.n_sphere_subs
    assert got.n_hoist == want.n_hoist
    assert got.n_sphere_subs_visit == want.n_sphere_subs_visit
    assert np.array_equal(got.hoist_params, np.asarray(want.hoist_params))
    cols = np.asarray(want.sph_sub_cols)
    assert np.array_equal(got.sph_sub_cols[..., :5], cols[:n, :, :5])
    assert np.array_equal(got.sph_sub_bounds, np.asarray(want.sph_sub_bounds)[:n])
    # the JAX tables go on with never-hit padding up to a whole super-cluster
    assert (cols[n:, :, 4] == 0).all() and (cols[n:, :, 3] == 0).all()
    # the permutation: every slot's centre and radius are its sphere's (the
    # JAX package keeps the permutation only through these columns and the
    # material rows gathered by it)
    live = got.sph_sub_cols[..., 3] > 0
    perm = got.perm.reshape(n, SUB)
    assert np.array_equal(centers[perm][live], cols[:n, :, :3][live])
    assert np.array_equal(radii[perm][live], cols[:n, :, 3][live])
    sph_mat = np.asarray(js.spheres.mat_idx)[got.perm]
    colour = np.asarray(js.materials.colour)[sph_mat]
    fields = list(want.attr_fields)
    attr = np.asarray(want.sph_attr)[:n].reshape(n * SUB, -1)
    for i, ch in enumerate(("col_r", "col_g", "col_b")):
        assert np.array_equal(attr[:, fields.index(ch)], colour[:, i]), ch


@pytest.mark.parametrize("name", SCENES)
def test_every_real_sphere_in_one_live_slot_inside_its_box(name):
    js = _scene(name)
    centers = np.asarray(js.spheres.center)
    radii = np.asarray(js.spheres.radius)
    got = pack_spheres(centers, radii)
    live = got.sph_sub_cols[..., 3] > 0
    perm = got.perm.reshape(-1, SUB)
    real = np.nonzero(radii > 0)[0]
    assert sorted(perm[live].tolist()) == real.tolist()
    assert (got.sph_sub_cols[..., 4][~live] == np.float32(-1e30)).all()
    for k in range(got.n_sphere_subs):
        members = perm[k][live[k]]
        if len(members):
            lo, hi = got.sph_sub_bounds[k, :3], got.sph_sub_bounds[k, 3:6]
            assert (centers[members] - radii[members, None] >= lo).all()
            assert (centers[members] + radii[members, None] <= hi).all()
    # hoisted spheres sit in the trailing block, in hoist_params' order
    hoisted = perm[got.n_sphere_subs_visit:][live[got.n_sphere_subs_visit:]]
    assert len(hoisted) == got.n_hoist
    for j, k in enumerate(hoisted):
        assert np.array_equal(got.hoist_params[8 * j: 8 * j + 3], centers[k])
    if name == "rtiow_final_scene":
        assert got.n_hoist == 4 and radii[hoisted[0]] == 1000.0
        assert live.sum(axis=1).tolist()[:15] == [32] * 15


@pytest.mark.parametrize("name", SCENES + ["empty"])
def test_kernel_sphere_tables(name):
    """``sphere_tables``: only real spheres have a slot, hoisted first, each
    cluster's slots in a run, its box one ulp wider than the sub-cluster's
    and holding its spheres in exact arithmetic."""
    if name == "empty":
        js = JBuilder().build()
    else:
        js = _scene(name)
    scene = scene_from_arrays(js, device="cpu")
    tab = tmk.sphere_tables(scene)
    centers = scene.spheres.center.numpy()
    radii = scene.spheres.radius.numpy()
    real = np.nonzero(radii > 0)[0]
    orig = tab["sphere_orig"].numpy()
    assert sorted(orig.tolist()) == real.tolist()
    rows = tab["spheres"].numpy()
    assert np.array_equal(rows[:, :3], centers[orig])
    assert np.array_equal(rows[:, 3], radii[orig] * radii[orig])
    assert np.array_equal(tab["sphere_mat"].numpy(),
                          scene.spheres.mat_idx.numpy()[orig])
    cl = tab["clusters"].numpy()
    bits = cl[:, [3, 7]].copy().view(np.int32)
    k = cl.shape[0]
    cluster_of = tab["cluster_of"].numpy()
    assert (cluster_of[orig[: tab["n_hoist"]]] == k).all()
    assert (cluster_of[radii <= 0] == k + 1).all()
    first = tab["n_hoist"]
    pack = pack_spheres(centers, radii)
    for c in range(k):
        assert bits[c, 0] == first and 1 <= bits[c, 1] <= SUB
        members = orig[first: first + bits[c, 1]]
        assert (cluster_of[members] == c).all()
        lo = centers[members].astype(np.float64) - radii[members, None]
        hi = centers[members].astype(np.float64) + radii[members, None]
        assert (lo >= cl[c, 0:3]).all() and (hi <= cl[c, 4:7]).all()
        first += bits[c, 1]
    assert first == len(real)
    live_subs = [s for s in range(pack.n_sphere_subs_visit)
                 if (pack.sph_sub_cols[s, :, 3] > 0).any()]
    assert k == len(live_subs)
    for c, s in enumerate(live_subs):
        assert np.array_equal(
            cl[c, 0:3], np.nextafter(pack.sph_sub_bounds[s, :3], np.float32(-np.inf)))
        assert np.array_equal(
            cl[c, 4:7], np.nextafter(pack.sph_sub_bounds[s, 3:6], np.float32(np.inf)))
    if name == "empty":
        assert k == 0 and rows.shape == (0, 4)
    if name == "cornell_box_scene":
        assert k == 1 and tab["n_hoist"] == 0 and bits[0, 1] == 2


def test_tables_are_built_once_a_scene():
    """``geometry_tables`` keeps a scene's tables on the scene object: a
    second call finds them, a scene with other arrays (an animation's next
    frame) or a tensor written in place builds anew."""
    js = _small_rtiow()
    scene = scene_from_arrays(js, device="cpu")
    before = tmk.TABLE_BUILDS.builds
    tab = tmk.geometry_tables(scene, "spheres")
    assert tmk.geometry_tables(scene, "spheres") is tab
    assert tmk.TABLE_BUILDS.builds == before + 1
    assert tab.cluster_seconds > 0.0
    moved = scene_from_arrays(js, device="cpu")
    assert tmk.geometry_tables(moved, "spheres") is not tab
    assert tmk.TABLE_BUILDS.builds == before + 2
    scene.spheres.center[0, 1] += 0.5
    again = tmk.geometry_tables(scene, "spheres")
    assert again is not tab and tmk.TABLE_BUILDS.builds == before + 3
    assert not torch.equal(again.spheres, tab.spheres)
