"""The port's whole render slice on the CPU against the JAX package.

Both packages render the same scene (handed over with ``interop``); the
port takes its plain PyTorch path, the JAX package its XLA path or, once,
the Pallas kernel in interpret mode. The tolerances are the JAX package's
own: the rule of ``tests/test_megakernel.py`` (over 99.5% of pixels within
1e-3 on every channel, mean abs difference under 1e-3) and, for RTIOW,
whose many small silhouettes can flip more pixels than that rule allows,
the tight gates of ``bench.py``.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ray_tracing_extended_tpu as rte
from ray_tracing_extended_tpu.kernels.megakernel import render_frame_mega
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.render import render_block as j_block
from ray_tracing_extended_tpu.scene.json_scene import load_json_scene as j_load
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.render import render_block as t_block

PORT = pathlib.Path(rtt.__file__).parent
SCENES = PORT.parent / "scenes"


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


def _port(j_scene, j_cam):
    return (scene_from_arrays(j_scene, device="cpu"),
            camera_from_arrays(j_cam, device="cpu"))


def _tight(a, b):
    """tests/test_megakernel.py's whole-frame rule."""
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


def _channel_mean_rel(a, b):
    return max(abs(float(a[..., c].mean()) - float(b[..., c].mean()))
               / max(float(b[..., c].mean()), 1e-9) for c in range(3))


def test_three_sphere_matches_xla():
    js, jc, cfg = jpresets.three_sphere_scene(width=64, height=32, spp=2)
    a, a_segs = rte.render_frame_with_stats(js, jc, cfg, jnp.uint32(3))
    b, b_segs = rtt.render_frame_with_stats(*_port(js, jc), cfg, 3)
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.005 * int(a_segs)


def test_render_block_matches_xla():
    js, jc, cfg = jpresets.three_sphere_scene(width=48, height=32, spp=2)
    pix = np.random.RandomState(0).randint(0, 48 * 32, 256).astype(np.int32)
    a, a_segs, a_counts = j_block(js, jc, cfg, jnp.uint32(1), jnp.asarray(pix),
                                  with_bounce_counts=True)
    b, b_segs, b_counts = t_block(*_port(js, jc), cfg, 1, torch.from_numpy(pix),
                                  with_bounce_counts=True)
    _tight(np.asarray(a), b.numpy())
    assert (b_segs.numpy() == np.asarray(a_segs)).mean() > 0.99
    assert int(b_counts[0]) == int(a_counts[0]) == 256 * 2


def test_rtiow_matches_xla_gates():
    js, jc, _ = jpresets.rtiow_final_scene(width=48, height=27)
    ts, tc = _port(js, jc)
    for mb, limit in ((1, 5e-3), (4, 2e-2)):
        cfg = rte.RenderConfig(width=48, height=27, max_bounce=mb, spp=2,
                               clamp_accumulate=False)
        a = np.asarray(rte.render_frame(js, jc, cfg, jnp.uint32(5)))
        b = rtt.render_frame(ts, tc, cfg, 5).numpy()
        assert _channel_mean_rel(b, a) < limit, mb
        if mb == 1:
            rel = (np.abs(a - b) / (1.0 + np.abs(a))).max(axis=-1)
            assert float(np.median(rel)) < 2e-3


def test_rtiow_mb0_no_defocus_matches_xla():
    js, jc, cfg = jpresets.rtiow_final_scene(width=48, height=27, max_bounce=0,
                                             spp=2)
    jc = dataclasses.replace(jc, defocus_strength=np.float32(0.0))
    a = np.asarray(rte.render_frame(js, jc, cfg, jnp.uint32(5)))
    b = rtt.render_frame(*_port(js, jc), cfg, 5).numpy()
    assert (np.abs(a - b).max(axis=-1) < 1e-5).mean() >= 0.98


def test_cornell_plain_matches_xla():
    js, jc, cfg = jpresets.cornell_box_scene(width=32, height=32, spp=1)
    a = np.asarray(rte.render_frame(js, jc, cfg, jnp.uint32(2)))
    b = rtt.render_frame(*_port(js, jc), cfg, 2).numpy()
    _tight(a, b)


@pytest.mark.parametrize("defocus", [True, False])
@pytest.mark.parametrize("name", ["chess", "knight"])
def test_shipped_triangle_scene_plain_matches_xla(name, defocus):
    """A shipped mirror through both packages' load_json_scene, at a small
    size, with its shipped defocus and without."""
    small = dict(width=48, height=27, spp=1, max_bounce=3)
    js, jc, cfg = j_load(SCENES / f"{name}.json", overrides=small)
    ts, tc, tcfg = rtt.load_json_scene(SCENES / f"{name}.json", overrides=small,
                                       device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert ts.has_triangles
    if not defocus:
        jc = dataclasses.replace(jc, defocus_strength=np.float32(0.0))
        tc = tc.replace(defocus_strength=0.0)
    a, a_segs = rte.render_frame_with_stats(js, jc, cfg, jnp.uint32(3))
    b, b_segs = rtt.render_frame_with_stats(ts, tc, cfg, 3)
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.005 * int(a_segs)


def test_triangle_scene_matches_tpu_kernel_interpret():
    """Cornell's walls are triangles: against the Pallas kernel in interpret
    mode, as the JAX package's own tests run it."""
    js, jc, cfg = jpresets.cornell_box_scene(width=32, height=32, spp=1,
                                             max_bounce=3)
    a, _ = render_frame_mega(js, jc, cfg, jnp.uint32(3), interpret=True)
    b = rtt.render_frame(*_port(js, jc), cfg, 3).numpy()
    _tight(np.asarray(a), b)


def test_plain_block_size_invariant_on_triangle_scene():
    """The plain path cuts its pixel block for scenes with many triangles;
    its images and per-pixel segments do not depend on the block."""
    scene, cam, cfg = rtt.load_json_scene(
        SCENES / "chess.json",
        overrides=dict(width=32, height=18, spp=1, max_bounce=2),
        device="cpu")
    prims = scene.spheres.count + scene.triangles.count
    assert prims == 128 + 6016
    # 1080p: (2^25 // prims) rounded down to a multiple of 256
    assert tmk.plain_block_size(
        dataclasses.replace(cfg, width=1920, height=1080), scene,
        1920 * 1080) == 5376
    assert tmk.plain_block_size(cfg, scene, 32 * 18) == 768
    small = dataclasses.replace(cfg, block_size=256)
    assert tmk.plain_block_size(small, scene, 32 * 18) == 256
    img, _, seg_map, _ = tmk.render_frames_plain(scene, cam, cfg, 4)
    img2, _, seg_map2, _ = tmk.render_frames_plain(scene, cam, small, 4)
    assert torch.equal(img, img2) and torch.equal(seg_map, seg_map2)


def test_matches_tpu_kernel_interpret():
    """Against the kernel being replaced, run as the JAX package's tests run
    it on the CPU."""
    js, jc, cfg = jpresets.three_sphere_scene(width=32, height=32, spp=1,
                                              max_bounce=2)
    a, _ = render_frame_mega(js, jc, cfg, jnp.uint32(3), interpret=True)
    b = rtt.render_frame(*_port(js, jc), cfg, 3).numpy()
    _tight(np.asarray(a), b)


def _small_rtiow():
    """A small RTIOW-like scene from a seed, built by the JAX package:
    a huge ground sphere and a big hero (both hoisted by the clustering)
    over 70 small spheres (three sub-clusters) of three materials."""
    from ray_tracing_extended_tpu.models.scene import Material as JMaterial
    from ray_tracing_extended_tpu.models.scene import SceneBuilder as JBuilder

    rs = np.random.RandomState(0)
    js, jc, _ = jpresets.rtiow_final_scene(width=8, height=8)
    b = JBuilder(env=js.env)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, JMaterial.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0.0, 1.0, 0.0), 1.0, JMaterial.dielectric(1.5))
    for i in range(70):
        x, z = i % 10 - 5 + 0.8 * rs.rand(), i // 10 - 3 + 0.8 * rs.rand()
        mat = (JMaterial.lambertian(tuple(rs.rand(3))) if i % 3 else
               JMaterial.metal(tuple(0.5 + 0.5 * rs.rand(3)), smoothness=1.0))
        b.add_sphere((x, 0.2, z), 0.2, mat)
    return b.build(), jc


def test_clustered_plain_frames_match_xla_and_tpu_kernel():
    """Whole frames through the clustered plain path (hoisted spheres,
    three sub-clusters behind their boxes) against the JAX package's XLA
    path and its Pallas kernel in interpret mode, by the rule of
    tests/test_megakernel.py: over 99.5% of pixels within 1e-3, mean
    absolute difference under 1e-3."""
    js, jc = _small_rtiow()
    cfg = rte.RenderConfig(width=32, height=32, max_bounce=2, spp=1)
    ts, tc = _port(js, jc)
    tab = tmk.geometry_tables(ts, "spheres")
    assert tab.n_hoist == 2 and tab.clusters.shape[0] == 3
    counts = {}
    fn = tmk.plain_intersector(ts, tc, cfg, counts)
    assert fn.func is tmk.closest_hit_clustered
    b = tmk.render_frames_plain(ts, tc, cfg, 3, intersect_fn=fn)[0].numpy()
    # the default path is that function, and the culls do cull
    assert np.array_equal(b, rtt.render_frame(ts, tc, cfg, 3).numpy())
    assert counts["sphere_tests"] < 0.6 * 72 * counts["segments"]
    a = np.asarray(rte.render_frame(js, jc, cfg, jnp.uint32(3)))
    _tight(a, b)
    k, _ = render_frame_mega(js, jc, cfg, jnp.uint32(3), interpret=True)
    _tight(np.asarray(k), b)


@pytest.mark.parametrize("name", ["chess", "knight"])
def test_clustered_plain_frames_equal_bruteforce_frames(name):
    """A shipped triangle scene (chunk boxes, and a box over each run of 32
    chunks) through the plain path with the kernel's culls and through the
    brute-force scan: the same frame and segment map (only a near-tie at a
    box's entry could differ)."""
    from ray_tracing_extended_tpu_torch.ops.intersect import (
        closest_hit_bruteforce,
    )

    scene, cam, cfg = rtt.load_json_scene(
        SCENES / f"{name}.json",
        overrides=dict(width=48, height=27, spp=1, max_bounce=3), device="cpu")
    assert tmk.geometry_tables(scene, "chunks").supers is not None
    a, _, a_map, _ = tmk.render_frames_plain(scene, cam, cfg, 3)
    b, _, b_map, _ = tmk.render_frames_plain(
        scene, cam, cfg, 3, intersect_fn=closest_hit_bruteforce)
    _tight(a.numpy(), b.numpy())
    assert (a_map == b_map).double().mean() > 0.995


def test_bounce_stats_match_xla():
    js, jc, cfg = jpresets.three_sphere_scene(width=64, height=32, spp=2)
    _, _, a = rte.render_frame_with_stats(js, jc, cfg, jnp.uint32(0),
                                          bounce_stats=True)
    _, segs, b = rtt.render_frame_with_stats(*_port(js, jc), cfg, 0,
                                             bounce_stats=True)
    a, b = np.asarray(a), b.numpy()
    assert b.shape == (cfg.max_bounce + 1,) and b.dtype == np.int32
    assert b[0] == 64 * 32 * 2  # every path is alive at bounce 0
    assert int(b.sum()) == int(segs)
    np.testing.assert_allclose(b, a, rtol=0.01, atol=2)


@pytest.mark.parametrize("clamp", [True, False])
def test_accumulation_matches_xla(clamp):
    js, jc, cfg = jpresets.three_sphere_scene(width=32, height=16, spp=1)
    cfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
    ts, tc = _port(js, jc)
    prev = np.random.RandomState(0).uniform(0, 1.5, (16, 32, 3)).astype(np.float32)

    a, a_segs = rte.render_frames_and_accumulate(
        js, jc, cfg, jnp.asarray(prev), jnp.uint32(2), n_frames=3
    )
    b, b_segs, b_map = rtt.render_frames_and_accumulate(
        ts, tc, cfg, torch.from_numpy(prev), 2, n_frames=3, segs_map=True
    )
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.005 * int(a_segs)
    assert b_map.shape == (16, 32) and int(b_map.sum()) == int(b_segs)

    a1 = rte.render_and_accumulate(js, jc, cfg, jnp.asarray(prev), jnp.uint32(4))
    b1 = rtt.render_and_accumulate(ts, tc, cfg, torch.from_numpy(prev), 4)
    _tight(np.asarray(a1), b1.numpy())


def test_batched_fold_equals_sequential_steps():
    scene, cam, cfg = tpresets.three_sphere_scene(width=24, height=16, spp=1,
                                                   device="cpu")
    acc0 = torch.zeros((16, 24, 3))
    batched, _ = rtt.render_frames_and_accumulate(scene, cam, cfg, acc0, 0, 3)
    seq = acc0
    for f in range(3):
        seq = rtt.render_and_accumulate(scene, cam, cfg, seq, f)
    assert torch.equal(batched, seq)


def test_plain_band_of_rows_equals_full_frame_rows():
    scene, cam, cfg = tpresets.rtiow_final_scene(width=40, height=24, spp=1,
                                                 max_bounce=2, device="cpu")
    acc0 = torch.from_numpy(
        np.random.RandomState(1).uniform(0, 2, (24, 40, 3)).astype(np.float32))
    full, _, full_map, _ = tmk.render_frames_plain(scene, cam, cfg, 1, 2,
                                                   accum=acc0)
    band, _, band_map, _ = tmk.render_frames_plain(
        scene, cam, cfg, 1, 2, accum=acc0[9:14].contiguous(), rows=(9, 14))
    assert band.shape == (5, 40, 3)
    assert torch.equal(band, full[9:14])
    assert torch.equal(band_map, full_map[9:14])
    with pytest.raises(ValueError):
        tmk.render_frames_plain(scene, cam, cfg, 1, rows=(20, 30))


def test_cpu_path_never_launches_the_kernel():
    scene, cam, cfg = tpresets.three_sphere_scene(width=16, height=8, spp=1,
                                                   device="cpu")
    before = tmk.KERNEL.launches
    img, segs, seg_map, hist = tmk.render_frames_mega(scene, cam, cfg, 0)
    assert tmk.KERNEL.launches == before
    assert img.shape == (8, 16, 3) and hist is None
    assert int(seg_map.sum()) <= int(segs)  # the total has padding lanes
    with pytest.raises(ValueError):
        tmk.render_frames_mega(scene, cam, cfg, 0, n_frames=2)
    with pytest.raises(ValueError):
        tmk.render_frames_mega(scene.to("meta"), cam, cfg, 0)


def test_bvh_options_render():
    """The BVH options that raised before the BVH was ported now render:
    ``intersector="bvh"`` on a scene without a BVH scans (the JAX package's
    ``closest_hit_bvh`` falls back the same way), ``build(build_bvh=...)``
    builds, and the mesh preset renders (tests/test_torch_bvh.py holds
    them to the JAX package)."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=16, height=8, spp=1,
                                                   device="cpu")
    ref = rtt.render_frame(scene, cam, cfg, 0)
    img = rtt.render_frame(scene, cam, dataclasses.replace(cfg, intersector="bvh"), 0)
    assert torch.equal(img, ref)
    built = rtt.SceneBuilder().build(build_bvh="tri", device="cpu")
    assert built.tri_bvh is None and built.sphere_bvh is None  # nothing to build
    with pytest.raises(ValueError):
        rtt.SceneBuilder().build(build_bvh="octree", device="cpu")
    scene, cam, cfg = tpresets.mesh_scene(width=16, height=8, target_tris=512,
                                          device="cpu")
    assert scene.has_tri_bvh and tmk.geometry(scene, cfg) == "bvh"
    assert bool(torch.isfinite(rtt.render_frame(scene, cam, cfg, 0)).all())


def test_unported_options_raise(tmp_path):
    """Every option of the JAX package is ported: an FBX mesh reaches the
    FBX reader (tests/test_torch_importers.py loads one), so a missing file
    raises as the JAX loader's does. The BVH renders
    (test_bvh_options_render); adaptive refill and fast scatter are ported
    (tests/test_torch_adaptive.py), and so is the multi-GPU split
    (test_progressive_mesh_matches_jax)."""
    from ray_tracing_extended_tpu.scene.json_scene import (
        load_json_scene as j_load_json_scene,
    )

    scene_file = tmp_path / "fbx.json"
    scene_file.write_text('{"meshes": [{"fbx": "knight.fbx"}]}')
    with pytest.raises(FileNotFoundError):
        j_load_json_scene(scene_file)
    with pytest.raises(FileNotFoundError, match="knight.fbx"):
        rtt.load_json_scene(scene_file, device="cpu")


def test_progressive_mesh_matches_jax():
    """``render_progressive(mesh=...)`` over a 1x2 mesh of the CPU against
    the JAX package's over two of its virtual CPU devices (its Pallas
    kernel in interpret mode), and bit for bit against the port's render
    without a mesh."""
    import jax

    from ray_tracing_extended_tpu.parallel.sharding import make_mesh as j_mesh
    from ray_tracing_extended_tpu_torch.parallel.sharding import make_mesh

    js, jc, cfg = jpresets.three_sphere_scene(width=32, height=16, spp=1)
    scene, cam = _port(js, jc)
    a = rte.render_progressive(js, jc, cfg, frames=2,
                               mesh=j_mesh(jax.devices()[:2]))
    b = rtt.render_progressive(scene, cam, cfg, frames=2,
                               mesh=make_mesh(["cpu", "cpu"]))
    _tight(np.asarray(a), b.numpy())
    assert torch.equal(b, rtt.render_progressive(scene, cam, cfg, frames=2))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    for module in ("accel/chunks.py", "scene/json_scene.py", "scene/mesh_io.py",
                   "parallel/sharding.py",
                   "progressive.py", "cli.py", "utils/checkpoint.py",
                   "utils/device.py", "utils/image.py", "utils/metrics.py",
                   "utils/profiling.py"):
        assert PORT / module in files, module
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib"), (path, name)
            assert not name.startswith("ray_tracing_extended_tpu."), (path, name)
            assert name != "ray_tracing_extended_tpu", (path, name)
    code = ("import sys, ray_tracing_extended_tpu_torch as m; "
            "import ray_tracing_extended_tpu_torch.cli; "
            "m.render_frame; print(sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('jax', 'jaxlib', 'ray_tracing_extended_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=PORT.parent)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_exports_every_name_of_the_jax_package():
    """The port's ``__all__`` holds every name of the JAX package's, and
    each resolves; ``load_json_scene`` is its one extra name."""
    assert set(rtt.__all__) - set(rte.__all__) == {"load_json_scene"}
    assert set(rte.__all__) <= set(rtt.__all__)
    for name in rtt.__all__:
        assert getattr(rtt, name) is not None, name


def test_bounce_histogram_counts_real_pixels_only():
    """On a frame whose pixel count is no multiple of the plain path's
    block (48x27 = 1296 pixels in one block of 1536 lanes), the histogram
    counts real pixels only, as the kernel's does: every real path at
    bounce 0, and it sums to the per-pixel segment map; the segment total,
    like the XLA path's, also counts the padding lanes."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=48, height=27, spp=2,
                                                   device="cpu")
    assert tmk.plain_block_size(cfg, scene, 48 * 27) == 1536
    img, segs, seg_map, hist = tmk.render_frames_plain(scene, cam, cfg, 4,
                                                       collect_stats=True)
    assert int(hist[0]) == 48 * 27 * cfg.spp
    assert int(hist.sum()) == int(seg_map.sum()) < int(segs)
    _, segs1, hist1 = rtt.render_frame_with_stats(scene, cam, cfg, 4,
                                                  bounce_stats=True)
    assert torch.equal(hist1, hist) and int(segs1) == int(segs)
