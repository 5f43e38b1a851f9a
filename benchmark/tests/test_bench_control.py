"""The control: the reference in bfloat16, put in the program's place,
comes out not correct under each cell's limits; so does the float32
reference on a shifted random stream. At a few pixels on the CPU here;
on the card at each cell's own size with ``benchmark/control.py``."""

import functools

import pytest
import torch

import control
import run
from ray_tracing_extended_tpu_torch.kernels import megakernel

CELLS = {
    "rtiow-final.batch": dict(width=16, height=16, spp=2, max_bounce=8),
    "chess.batch": dict(width=16, height=16, spp=2, max_bounce=3),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_the_check(cell, monkeypatch):
    monkeypatch.setattr(megakernel, "plain_intersector", functools.partial(
        megakernel.plain_intersector, direct=True))
    monkeypatch.setattr(run, "WARM_SECONDS", 0.05)
    result = run.run_cell(cell, 2 ** 31 + 99, 0.2, False, device="cpu",
                          shrink=CELLS[cell], keep=True)
    assert result["correct"]
    readings = control.control_readings(result["_state"])
    assert not readings["control_bf16"]["correct"], readings
    assert not readings["stream_shift"]["correct"], readings
    assert not readings["half_samples"]["correct"], readings


@pytest.mark.cuda
def test_a_short_cell_on_the_card(card):
    """One cell's run through ``run.main`` on a card, short."""
    result = run.run_cell("chess.batch", 2 ** 31 + 5, 1.0, False)
    assert result["device"]["platform"] == "gpu"
    assert result["correct"], result["checks"]
    torch.cuda.empty_cache()
