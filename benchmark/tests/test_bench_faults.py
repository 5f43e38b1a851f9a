"""The check, driven through a whole run on the CPU at a few pixels (the
look for a card skipped), holds a sound run and refuses the timed path
broken underneath: a step that leaves the running average unchanged,
half of each frame's samples left out with the mean over the rest, and a
frame's answer altered where it is produced (its random stream)."""

import dataclasses
import functools

import pytest

import run
from ray_tracing_extended_tpu_torch import progressive
from ray_tracing_extended_tpu_torch.kernels import megakernel

CELLS = {
    "rtiow-final.batch": dict(width=16, height=16, spp=2, max_bounce=8),
    "chess.interactive": dict(width=16, height=16, spp=2, max_bounce=3),
}


@pytest.fixture(autouse=True)
def _direct_forms(monkeypatch):
    """The port's CPU path in the kernel's test forms, as on the card, and
    a short warm-up."""
    monkeypatch.setattr(megakernel, "plain_intersector", functools.partial(
        megakernel.plain_intersector, direct=True))
    monkeypatch.setattr(run, "WARM_SECONDS", 0.05)


def go(cell):
    return run.run_cell(cell, 2 ** 31 + 7, 0.2, False, device="cpu",
                        shrink=CELLS[cell])


def break_step(monkeypatch, fault):
    batched = progressive.render_frames_and_accumulate
    single = progressive.render_frame_with_stats

    def alter(cfg, frame):
        if fault == "half":
            cfg = dataclasses.replace(cfg, spp=cfg.spp // 2)
        return cfg, frame + 1 if fault == "stream" else frame

    def fused(scene, camera, cfg, accum, frame0, n, **kw):
        cfg2, f0 = alter(cfg, frame0)
        out = batched(scene, camera, cfg2, accum, f0, n, **kw)
        return (accum, *out[1:]) if fault == "unchanged" else out

    def one(scene, camera, cfg, frame, **kw):
        cfg2, f = alter(cfg, frame)
        return single(scene, camera, cfg2, f, **kw)

    monkeypatch.setattr(progressive, "render_frames_and_accumulate", fused)
    monkeypatch.setattr(progressive, "render_frame_with_stats", one)
    if fault == "unchanged":
        monkeypatch.setattr(progressive, "accumulate",
                            lambda prev, cur, frame, clamp=True: prev)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    result = go(cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["image_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["unchanged", "half", "stream"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    break_step(monkeypatch, fault)
    result = go(cell)
    assert not result["correct"], result["checks"]
