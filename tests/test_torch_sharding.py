"""The port's multi-GPU split (``parallel/sharding.py``) on the CPU, on
meshes that list the CPU several times: the stitched bands against the
single-device render bit for bit (exact and refill; spheres, chunks and
the BVH; single frames and K-frame folds), the ``spp`` axis against the
sequential fold, the progressive driver over a mesh, and the JAX package's
sharded paths on its 8 virtual CPU devices.

Within the port, images, accumulators and per-pixel segment maps are held
bit for bit. On the plain exact-spp path a segment total also counts the
padding lanes of each pixel block, whose number depends on the band, so
there totals are compared only where no block has padding. Against the JAX
package (its XLA path, or its Pallas kernel in interpret mode with
conftest's ``RTX_MEGA_TS=32``), whole frames are held to the rule of
``tests/test_megakernel.py:20-31`` (over 99.5% of pixels within 1e-3,
mean abs difference under 1e-3); the ``spp`` folds to the JAX tests'
``atol`` (``tests/test_sharding.py``: 2e-5 HDR, 2e-6 clamped).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.parallel import sharding as jsh
from ray_tracing_extended_tpu.progressive import (
    render_progressive as j_progressive,
)
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.ops import vecmath as vm
from ray_tracing_extended_tpu_torch.parallel import sharding as sh


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
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


def _cpu_mesh(spp, tiles):
    return sh.make_mesh(["cpu"] * (spp * tiles), spp_parallel=spp)


def _scene(geometry, **size):
    """Spheres (RTIOW's clustered tables), chunks (Cornell) or the BVH
    (the mesh preset, cut to a few hundred triangles), on the CPU."""
    if geometry == "spheres":
        return tpresets.rtiow_final_scene(device="cpu", **size)
    if geometry == "chunks":
        return tpresets.cornell_box_scene(device="cpu", **size)
    return tpresets.mesh_scene(target_tris=400, device="cpu", **size)


def test_make_mesh_and_band_layout():
    mesh = _cpu_mesh(2, 4)
    assert mesh.shape == {"spp": 2, "tiles": 4}
    assert mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="does not divide"):
        sh.make_mesh(["cpu"] * 4, spp_parallel=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sh.make_mesh()
    # ceil(ceil(H / tiles) / 8) * 8, whatever the launch's flags
    _, _, cfg = tpresets.three_sphere_scene(width=8, height=1080, device="cpu")
    mesh4 = _cpu_mesh(1, 4)
    for flags in ((False, False), (True, True)):
        assert sh.mega_band_height(None, cfg, mesh4, *flags) == 272
    bands = sh.init_accum_mega_bands(None, cfg, mesh4, batched=True)
    assert [b.shape[0] for b in bands] == [272, 272, 272, 264]
    cfg100 = dataclasses.replace(cfg, height=100)
    assert sh.mega_band_height(None, cfg100, _cpu_mesh(1, 8)) == 16
    blocks = sh.init_accum_blocks(cfg100, _cpu_mesh(1, 8))
    assert [b.shape[0] for b in blocks] == [16] * 6 + [4, 0]
    image = torch.arange(100 * 8 * 3, dtype=torch.float32).reshape(100, 8, 3)
    back = sh.blocks_to_image(sh.image_to_bands(image, cfg100,
                                                _cpu_mesh(1, 8)), cfg100)
    assert torch.equal(back, image)


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
@pytest.mark.parametrize("geometry", ["spheres", "chunks", "bvh"])
def test_band_split_equals_single_device(geometry, adaptive):
    """A 1x4 split of a 36-row frame (bands of 16, 16, 4 and no row): one
    frame, and a 2-frame fold from a seeded accumulator, stitched, equal
    the single-device render bit for bit, per-pixel segments too. Refill
    on tiles of 16 (the config's), so that its bands, of whole tiles, are
    the exact split's."""
    scene, cam, cfg = _scene(geometry, width=16, height=36, spp=1,
                             max_bounce=3)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive,
                              mega_tile_size=16 if adaptive else None)
    assert tmk.geometry(scene, cfg) == geometry
    mesh = _cpu_mesh(1, 4)
    img, segs = sh.render_frame_mega_sharded(scene, cam, cfg, 3, mesh)
    ref, ref_segs, ref_map, _ = tmk.render_frames_mega(scene, cam, cfg, 3)
    assert torch.equal(img, ref)

    acc0 = torch.from_numpy(np.random.RandomState(0).uniform(
        0.0, 2.0, (36, 16, 3)).astype(np.float32))
    bands = sh.image_to_bands(acc0, cfg, mesh)
    out, total, maps = sh.render_frames_mega_sharded(scene, cam, cfg, 2,
                                                     bands, 2, mesh)
    acc, acc_total, acc_map, _ = tmk.render_frames_mega(scene, cam, cfg, 2, 2,
                                                        accum=acc0)
    assert torch.equal(sh.mega_bands_to_image(out, cfg), acc)
    assert torch.equal(torch.cat(maps), acc_map)
    assert [b.shape[0] for b in out] == [16, 16, 4, 0]
    if adaptive:  # refill totals count real pixels only
        assert int(segs) == int(ref_segs) and int(total) == int(acc_total)
    assert int(total) >= int(acc_map.sum())


def test_odd_height_split_into_eight_bands():
    """tests/test_mega_sharded.py's odd height: 100 rows in 8 bands of 16,
    the seventh cut to 4 rows and the last past the frame (no launch);
    refill on tiles of 16."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=16, height=100, spp=1,
                                                  device="cpu")
    mesh = _cpu_mesh(1, 8)
    for adaptive in (False, True):
        vcfg = dataclasses.replace(cfg, adaptive_spp=adaptive,
                                   mega_tile_size=16 if adaptive else None)
        img, segs = sh.render_frame_mega_sharded(scene, cam, vcfg, 0, mesh)
        ref, ref_segs, _, _ = tmk.render_frames_mega(scene, cam, vcfg, 0)
        assert img.shape == (100, 16, 3) and torch.equal(img, ref)
        if adaptive:
            assert int(segs) == int(ref_segs)


def test_refill_band_rule():
    """render_frames_mega(rows=...) takes any band with exact spp; with
    refill only one on rows of the refill tiles (16 here, or ending at the
    frame's edge), on the CPU as on the card; with the default tiles of 128
    a 28-row frame is one tile, so only the whole frame."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=16, height=28, spp=1,
                                                  device="cpu")
    whole = tmk.render_frames_mega(scene, cam, cfg, 1)[0]
    band = tmk.render_frames_mega(scene, cam, cfg, 1, rows=(3, 17))[0]
    assert torch.equal(band, whole[3:17])
    acfg = dataclasses.replace(cfg, adaptive_spp=True, mega_tile_size=16)
    whole = tmk.render_frames_mega(scene, cam, acfg, 1)[0]
    for rows in ((0, 16), (16, 28)):
        band = tmk.render_frames_mega(scene, cam, acfg, 1, rows=rows)[0]
        assert torch.equal(band, whole[slice(*rows)])
    for rows in ((8, 16), (2, 10), (8, 20), (16, 24)):
        with pytest.raises(ValueError, match="whole tiles"):
            tmk.render_frames_mega(scene, cam, acfg, 1, rows=rows)
    dcfg = dataclasses.replace(cfg, adaptive_spp=True)
    with pytest.raises(ValueError, match="whole tiles"):
        tmk.render_frames_mega(scene, cam, dcfg, 1, rows=(16, 28))
    for rows in ((5, 5), (0, 29), (-8, 8)):
        with pytest.raises(ValueError, match="outside"):
            tmk.render_frames_mega(scene, cam, cfg, 1, rows=rows)


def test_spp_rows_mean_and_segment_total():
    """tests/test_mega_sharded.py's 2x4 mesh: the image is the mean of
    frames f and f + 1, summed and divided by 2 with vecmath.div, bit for
    bit; the total their totals' sum (32x32 in bands of 8 rows: no pixel
    block has padding)."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=32, height=32, spp=1,
                                                  device="cpu")
    img, segs = sh.render_frame_mega_sharded(scene, cam, cfg, 4,
                                             _cpu_mesh(2, 4))
    a0, s0, _, _ = tmk.render_frames_mega(scene, cam, cfg, 4)
    a1, s1, _, _ = tmk.render_frames_mega(scene, cam, cfg, 5)
    assert torch.equal(img, vm.div(a0 + a1, 2.0))
    assert int(segs) == int(s0) + int(s1)


@pytest.mark.parametrize("clamp,atol", [(False, 2e-5), (True, 2e-6)],
                         ids=["hdr", "clamped"])
def test_spp_mesh_steps_equal_sequential_fold(clamp, atol):
    """A 4x2 mesh over two steps (frames 0-3, then 4-7) against the frames
    folded one at a time: HDR folds the 4 frames' mean with weight 4 /
    (frame + 4); parity mode folds them one at a time, each clamped."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=32, height=16, spp=2,
                                                  device="cpu")
    cfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
    mesh = _cpu_mesh(4, 2)
    accum = sh.init_accum_blocks(cfg, mesh)
    accum = sh.render_step_sharded(scene, cam, cfg, accum, 0, mesh)
    accum = sh.render_step_sharded(scene, cam, cfg, accum, 4, mesh)
    img = sh.blocks_to_image(accum, cfg).numpy()
    ref = np.zeros((16, 32, 3), np.float32)
    for f in range(8):
        cur = rtt.render_frame(scene, cam, cfg, f).numpy()
        w = np.float32(1.0 / (f + 1))
        ref = ref * (1 - w) + cur * w
        if clamp:
            ref = np.clip(ref, 0.0, 1.0)
    assert np.allclose(img, ref, atol=atol), np.abs(img - ref).max()


def test_render_frame_sharded_is_the_frames_mean():
    """render_frame_sharded on a 2x4 mesh: frame f's seeds 2f and 2f + 1,
    their mean clamped (the preset clamps), at any f; the JAX module's
    folds frame f with weight 1 / (f + 1), so only its frame 0 is the
    image (the comparison with it: below)."""
    scene, cam, cfg = tpresets.three_sphere_scene(width=32, height=16, spp=1,
                                                  device="cpu")
    assert cfg.clamp_accumulate
    for f in (0, 2):
        img = sh.render_frame_sharded(scene, cam, cfg, f, _cpu_mesh(2, 4))
        mean = vm.div(rtt.render_frame(scene, cam, cfg, 2 * f)
                      + rtt.render_frame(scene, cam, cfg, 2 * f + 1), 2.0)
        assert torch.equal(img, vm.saturate(mean))


def _both_three_sphere(**size):
    js, jc, cfg = jpresets.three_sphere_scene(**size)
    ts, tc, tcfg = tpresets.three_sphere_scene(device="cpu", **size)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return (js, jc), (ts, tc), cfg


def test_sharded_frames_match_the_jax_package():
    """The port's sharded frame against the JAX package's on its 8 virtual
    CPU devices: render_frame_mega_sharded on a 2x4 mesh (the JAX side its
    Pallas kernel in interpret mode), render_frame_sharded on 1x8 (its XLA
    path); the whole-frame rule, and the same segment total within the
    padding the JAX bands add."""
    assert len(jax.devices()) == 8
    (js, jc), (ts, tc), cfg = _both_three_sphere(width=32, height=32, spp=1,
                                                 max_bounce=2)
    a, a_segs = jsh.render_frame_mega_sharded(
        js, jc, cfg, jnp.uint32(2), jsh.make_mesh(spp_parallel=2))
    b, b_segs = sh.render_frame_mega_sharded(ts, tc, cfg, 2, _cpu_mesh(2, 4))
    _tight(np.asarray(a), b.numpy())
    assert int(b_segs) > 0 and int(a_segs) > 0
    a = jsh.render_frame_sharded(js, jc, cfg, 0, jsh.make_mesh())
    b = sh.render_frame_sharded(ts, tc, cfg, 0, _cpu_mesh(1, 8))
    _tight(a, b.numpy())


def test_progressive_tail_chunk_under_a_split():
    """frames=5, batch=2 over a 1x2 mesh: chunks of 2, 2 and a 1-frame tail
    (the JAX driver recomputes the tail's band height from another tile
    size and can raise there; the port's band layout does not depend on
    the chunk): bit for bit the single-device batched render, and within
    the rule of the JAX package's sharded driver."""
    (js, jc), (ts, tc), cfg = _both_three_sphere(width=32, height=16, spp=1)
    mesh = _cpu_mesh(1, 2)
    img = rtt.render_progressive(ts, tc, cfg, frames=5, batch=2, mesh=mesh)
    assert torch.equal(img, rtt.render_progressive(ts, tc, cfg, frames=5,
                                                   batch=2))
    assert torch.equal(img, rtt.render_progressive(ts, tc, cfg, frames=5,
                                                   mesh=mesh))
    ref = j_progressive(js, jc, cfg, frames=5, batch=2,
                        mesh=jsh.make_mesh(jax.devices()[:2]))
    _tight(ref, img.numpy())


def _flythrough():
    js, jcams, cfg = jpresets.flythrough_cameras(2, width=32, height=16)
    ts, tcams, _ = tpresets.flythrough_cameras(2, width=32, height=16,
                                               device="cpu")
    return js, jcams, ts, tcams, dataclasses.replace(cfg, spp=1, max_bounce=2)


def test_spp_mesh_flythrough_matches_jax_and_refusals():
    """tests/test_mega_sharded.py's spp fly-through (HDR, 2x2 mesh, a camera
    a step) against the JAX driver, and what the driver refuses: the
    per-frame clamp on an spp mesh, batches on an spp mesh or with
    cameras, per-frame scenes."""
    js, jcams, ts, tcams, cfg = _flythrough()
    assert not cfg.clamp_accumulate
    mesh = _cpu_mesh(2, 2)
    img = rtt.render_progressive(ts, None, cfg, frames=2, cameras=tcams,
                                 mesh=mesh)
    ref = j_progressive(js, None, cfg, frames=2, cameras=jcams,
                        mesh=jsh.make_mesh(jax.devices()[:4], spp_parallel=2))
    _tight(ref, img.numpy())
    # the step folds: step s the mean of seeds 2s, 2s + 1 with weight 1/(s+1)
    acc = torch.zeros_like(img)
    for s in range(2):
        mean = vm.div(rtt.render_frame(ts, tcams[s], cfg, 2 * s)
                      + rtt.render_frame(ts, tcams[s], cfg, 2 * s + 1), 2.0)
        acc = rtt.accumulate(acc, mean, s, clamp=False)
    assert torch.equal(img, acc)
    with pytest.raises(ValueError, match="spp-sharded"):
        rtt.render_progressive(ts, None, dataclasses.replace(
            cfg, clamp_accumulate=True), frames=2, cameras=tcams, mesh=mesh)
    with pytest.raises(ValueError, match="spp_parallel=1"):
        rtt.render_progressive(ts, tcams[0], cfg, frames=2, batch=2, mesh=mesh)
    with pytest.raises(ValueError, match="batch=1"):
        rtt.render_progressive(ts, None, cfg, frames=2, batch=2,
                               cameras=tcams, mesh=_cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="single-device"):
        rtt.render_progressive(ts, tcams[0], cfg, frames=2, scenes=[ts, ts],
                               mesh=_cpu_mesh(1, 2))


def test_reset_on_move_split_equals_single_device():
    """tests/test_mega_sharded.py's reset_on_move over a 1x2 mesh: after
    the camera moves the result is the moved camera's frame alone, and the
    whole run equals the single-device driver bit for bit."""
    _, _, ts, tcams, cfg = _flythrough()
    cameras = [tcams[0], tcams[0], tcams[1]]
    img = rtt.render_progressive(ts, None, cfg, frames=3, cameras=cameras,
                                 mesh=_cpu_mesh(1, 2), reset_on_move=True)
    assert torch.equal(img, rtt.render_progressive(
        ts, None, cfg, frames=3, cameras=cameras, reset_on_move=True))
    frame2 = rtt.render_frame(ts, tcams[1], cfg, 2)
    assert torch.equal(img, rtt.accumulate(torch.zeros_like(img), frame2, 0,
                                           clamp=cfg.clamp_accumulate))


def test_sharded_checkpoints_cross_packages(tmp_path):
    """A checkpoint the JAX sharded driver wrote resumes in the port's, and
    one the port's wrote (a reset_on_move fly-through, whose fingerprint
    carries the suffix) resumes in the JAX package's; each ends within the
    rule of the other package's straight run."""
    (js, jc), (ts, tc), cfg = _both_three_sphere(width=32, height=16, spp=1)
    jmesh, tmesh = jsh.make_mesh(jax.devices()[:2]), _cpu_mesh(1, 2)
    ck = tmp_path / "jax.npz"
    j_progressive(js, jc, cfg, frames=2, checkpoint_path=str(ck), mesh=jmesh)
    resumed = rtt.render_progressive(ts, tc, cfg, frames=1, checkpoint_path=ck,
                                     resume=True, mesh=tmesh)
    _tight(j_progressive(js, jc, cfg, frames=3, mesh=jmesh), resumed.numpy())

    js, jcams, ts, tcams, cfg = _flythrough()
    jpath, tpath = [jcams[0], jcams[0], jcams[1]], [tcams[0], tcams[0], tcams[1]]
    ck = tmp_path / "torch.npz"
    rtt.render_progressive(ts, None, cfg, frames=2, cameras=tpath,
                           checkpoint_path=ck, mesh=tmesh, reset_on_move=True)
    resumed = j_progressive(js, None, cfg, frames=1, cameras=jpath,
                            checkpoint_path=str(ck), resume=True, mesh=jmesh,
                            reset_on_move=True)
    straight = rtt.render_progressive(ts, None, cfg, frames=3, cameras=tpath,
                                      mesh=tmesh, reset_on_move=True)
    _tight(resumed, straight.numpy())
    with np.load(ck) as z:
        assert int(z["frame"]) == 3
