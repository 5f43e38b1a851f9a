"""The port's progressive renderer, checkpoints and metrics on the CPU against
the JAX package's (``ray_tracing_extended_tpu/progressive.py``).

On the CPU the JAX package renders through its XLA path and the port
through the plain PyTorch path, so whole images are held to
``tests/test_megakernel.py``'s rule (over 99.5% of pixels within 1e-3,
mean abs difference under 1e-3); within the port, a resumed or fused
render is held to the straight one bit for bit. The fly-through renders
RTIOW, whose many small silhouettes flip more pixels than that rule allows
at 32x16; it is held to ``bench.py``'s gates instead, as
``tests/test_torch_render.py`` holds RTIOW (median per-pixel relative
difference under 2e-3, channel means within 2e-2 past one bounce).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.models import scene as jscene
from ray_tracing_extended_tpu.progressive import (
    render_progressive as j_progressive,
)
from ray_tracing_extended_tpu.utils import checkpoint as jckpt
from ray_tracing_extended_tpu.utils.metrics import MetricsLogger as JLogger
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.models import scene as tscene
from ray_tracing_extended_tpu_torch.utils import checkpoint as tckpt
from ray_tracing_extended_tpu_torch.utils.metrics import MetricsLogger


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


def _rtiow_gates(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = (np.abs(a - b) / (1.0 + np.abs(a))).max(axis=-1)
    assert float(np.median(rel)) < 2e-3
    for c in range(3):
        assert abs(a[..., c].mean() - b[..., c].mean()) <= 2e-2 * a[..., c].mean()


def _both(width=32, height=16, spp=2, max_bounce=4):
    """The three-sphere preset in each package, the port's on the CPU."""
    js, jc, cfg = jpresets.three_sphere_scene(width=width, height=height,
                                              spp=spp, max_bounce=max_bounce)
    ts, tc, tcfg = tpresets.three_sphere_scene(width=width, height=height,
                                               spp=spp, max_bounce=max_bounce,
                                               device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return (js, jc), (ts, tc), cfg


def test_static_camera_matches_jax():
    (js, jc), (ts, tc), cfg = _both()
    a = j_progressive(js, jc, cfg, frames=3)
    b = rtt.render_progressive(ts, tc, cfg, frames=3)
    assert b.shape == (16, 32, 3) and b.device.type == "cpu"
    _tight(a, b.numpy())


def test_batch_matches_jax_and_the_per_frame_loop():
    """batch=3 over 5 frames (a tail chunk of 2): against the JAX package's
    batch=3, and bit for bit against the port's per-frame loop."""
    (js, jc), (ts, tc), cfg = _both(spp=1)
    a = j_progressive(js, jc, cfg, frames=5, batch=3)
    b = rtt.render_progressive(ts, tc, cfg, frames=5, batch=3)
    _tight(a, b.numpy())
    assert torch.equal(b, rtt.render_progressive(ts, tc, cfg, frames=5))


def _flythrough(n):
    js, jcams, cfg = jpresets.flythrough_cameras(n, width=32, height=16)
    ts, tcams, tcfg = tpresets.flythrough_cameras(n, width=32, height=16,
                                                  device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    cfg = dataclasses.replace(cfg, spp=1, max_bounce=2)
    return js, jcams, ts, tcams, cfg


def test_reset_on_move_flythrough_matches_jax(tmp_path):
    """A fly-through path that holds each camera for two frames, with the
    running average restarting on every move: against the JAX package, and
    a resume in the middle of a run scans back to the run's start."""
    js, jcams, ts, tcams, cfg = _flythrough(2)
    for a, b in zip(jcams, tcams):
        for name in ("position", "rotation", "focus_distance"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)))
    jpath = [jcams[0], jcams[0], jcams[1], jcams[1], jcams[1]]
    tpath = [tcams[0], tcams[0], tcams[1], tcams[1], tcams[1]]
    a = j_progressive(js, None, cfg, frames=5, cameras=jpath,
                      reset_on_move=True)
    b = rtt.render_progressive(ts, None, cfg, frames=5, cameras=tpath,
                               reset_on_move=True)
    _rtiow_gates(a, b.numpy())
    # the trailing run alone, as a fresh render of frames 2..4
    fresh = torch.zeros((16, 32, 3))
    for k, f in enumerate((2, 3, 4)):
        cur = rtt.render_frame(ts, tcams[1], cfg, f)
        fresh = rtt.accumulate(fresh, cur, k, clamp=cfg.clamp_accumulate)
    assert torch.equal(b, fresh)
    ck = tmp_path / "fly.npz"
    rtt.render_progressive(ts, None, cfg, frames=4, cameras=tpath,
                           reset_on_move=True, checkpoint_path=ck)
    resumed = rtt.render_progressive(ts, None, cfg, frames=1, cameras=tpath,
                                     reset_on_move=True, checkpoint_path=ck,
                                     resume=True)
    assert torch.equal(resumed, b)
    with pytest.raises(ValueError, match="reset_on_move requires"):
        rtt.render_progressive(ts, tcams[0], cfg, frames=1, reset_on_move=True)


def _animated(mod, device_kw, n=3):
    """A sphere moving across the three-sphere scene, one build a frame."""
    b = mod.SceneBuilder(env=(jpresets if mod is jscene else tpresets)._gradient_sky())
    b.add_sphere((0.0, -100.5, 0.0), 100.0, mod.Material.lambertian((0.8, 0.8, 0.0)))
    b.add_sphere((0.0, 0.0, 0.0), 0.5, mod.Material.lambertian((0.1, 0.2, 0.5)))
    b.add_sphere((1.05, 0.0, 0.0), 0.5, mod.Material.metal((0.8, 0.6, 0.2)))
    scenes = []
    for f in range(n):
        b.set_sphere(1, center=(0.2 * f - 0.2, 0.0, 0.0))
        scenes.append(b.build(**device_kw))
    return scenes


def test_animated_scenes_match_jax(tmp_path):
    (_, jc), (_, tc), cfg = _both(spp=1)
    jsc = _animated(jscene, {})
    tsc = _animated(tscene, {"device": "cpu"})
    a = j_progressive(jsc[0], jc, cfg, frames=3, scenes=jsc)
    b = rtt.render_progressive(tsc[0], tc, cfg, frames=3, scenes=tsc)
    _tight(a, b.numpy())
    # the animation is part of the fingerprint
    ck = tmp_path / "anim.npz"
    rtt.render_progressive(tsc[0], tc, cfg, frames=2, scenes=tsc,
                           checkpoint_path=ck)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        rtt.render_progressive(tsc[0], tc, cfg, frames=1, scenes=tsc[::-1],
                               checkpoint_path=ck, resume=True)
    bigger = tscene.SceneBuilder()
    for i in range(130):  # one more padding block of spheres
        bigger.add_sphere((0.0, 0.0, float(i)), 0.1, tscene.Material())
    with pytest.raises(ValueError, match="shapes"):
        rtt.render_progressive(tsc[0], tc, cfg, frames=2,
                               scenes=[tsc[0], bigger.build(device="cpu")])


@pytest.mark.parametrize("batch", [1, 2])
def test_resume_equals_straight_run(tmp_path, batch):
    (_, _), (ts, tc), cfg = _both(spp=1)
    straight = rtt.render_progressive(ts, tc, cfg, frames=4, batch=batch)
    ck = tmp_path / "ck.npz"
    rtt.render_progressive(ts, tc, cfg, frames=2, checkpoint_path=ck,
                           checkpoint_every=1, batch=batch)
    resumed = rtt.render_progressive(ts, tc, cfg, frames=2, checkpoint_path=ck,
                                     resume=True, batch=batch)
    assert torch.equal(resumed, straight)
    with np.load(ck) as z:
        assert sorted(z.files) == ["accum", "fingerprint", "frame"]
        assert int(z["frame"]) == 4
        np.testing.assert_array_equal(z["accum"], straight.numpy())


def test_mismatched_fingerprint_is_refused(tmp_path):
    (_, _), (ts, tc), cfg = _both(spp=1)
    ck = tmp_path / "ck.npz"
    rtt.render_progressive(ts, tc, cfg, frames=1, checkpoint_path=ck)
    for change in (dataclasses.replace(cfg, max_bounce=cfg.max_bounce + 1),
                   dataclasses.replace(cfg, adaptive_spp=True)):
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            rtt.render_progressive(ts, tc, change, frames=1,
                                   checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        rtt.render_progressive(ts, tc.replace(fov_y_deg=50.0), cfg, frames=1,
                               checkpoint_path=ck, resume=True)


@pytest.mark.parametrize("preset", ["three_sphere_scene", "cornell_box_scene"])
def test_fingerprint_equals_jax(preset):
    js, jc, cfg = getattr(jpresets, preset)(width=24, height=16)
    ts, tc, _ = getattr(tpresets, preset)(width=24, height=16, device="cpu")
    assert tckpt.state_hash(ts, tc, cfg) == jckpt.state_hash(js, jc, cfg)
    # handed over from the JAX package, too
    ps, pc = (scene_from_arrays(js, device="cpu"),
              camera_from_arrays(jc, device="cpu"))
    assert tckpt.state_hash(ps, pc, cfg) == jckpt.state_hash(js, jc, cfg)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The state carried across: a checkpoint the JAX package wrote after
    two frames resumes in the port, which renders two more, and ends at the
    JAX package's straight four-frame image."""
    (js, jc), (ts, tc), cfg = _both(spp=1)
    ck = tmp_path / "jax.npz"
    j_progressive(js, jc, cfg, frames=2, checkpoint_path=str(ck))
    resumed = rtt.render_progressive(ts, tc, cfg, frames=2,
                                     checkpoint_path=ck, resume=True)
    _tight(j_progressive(js, jc, cfg, frames=4), resumed.numpy())
    accum, frame = tckpt.load(ck)
    assert frame == 4 and accum.shape == (16, 32, 3)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("batch", [1, 2])
def test_metrics_keys_equal_jax(tmp_path, batch):
    (js, jc), (ts, tc), cfg = _both(spp=1)
    jl = JLogger(str(tmp_path / "j.jsonl"))
    j_progressive(js, jc, cfg, frames=3, metrics=jl, batch=batch)
    jl.close()
    tl = MetricsLogger(tmp_path / "t.jsonl")
    rtt.render_progressive(ts, tc, cfg, frames=3, metrics=tl, batch=batch)
    tl.close()
    a, b = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert [sorted(x) for x in b] == [sorted(x) for x in a]
    assert [x["frame"] for x in b] == [x["frame"] for x in a]
    for x in b:
        assert x["mrays_per_s"] > 0
        assert 1.0 <= x["rays_per_path"] <= cfg.max_bounce + 1
    if batch == 1:
        for x, y in zip(b, a):
            assert x["alive_frac"][0] == 1.0
            np.testing.assert_allclose(x["alive_frac"], y["alive_frac"],
                                       atol=0.01)
            assert abs(sum(x["alive_frac"]) - x["rays_per_path"]) < 1e-2
        assert b[2]["accum_var"] < b[1]["accum_var"]
