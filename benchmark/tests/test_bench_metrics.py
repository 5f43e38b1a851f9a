"""The harness's metric arithmetic on synthetic windows and timelines."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

import run
import trace_events

BENCH = Path(__file__).resolve().parents[1]


def ctx_of(stamps, segments, batched, t0=0.0, spp=3, trace=None):
    window = stamps[-1] - t0
    return dict(t0=t0, stamps=stamps, segments=sum(segments),
                batched=batched, frames=sum(batched), window_s=window,
                cfg=SimpleNamespace(spp=spp, width=4, height=2),
                setup_s=12.5, trace=trace, counts={"ops": 0.0, "segments": 0},
                batch=batched[0], scene_bytes=0, root=BENCH)


def read(name, ctx):
    return run.load_reader(name).read(ctx)


def test_rates_take_all_the_work_over_the_whole_window():
    # 4 frames of 1e6 segments, 10 ms apart, the first 30 ms after t0
    stamps = [0.03, 0.04, 0.05, 0.06]
    ctx = ctx_of(stamps, [10 ** 6] * 4, [1] * 4)
    assert read("mrays_per_s", ctx) == pytest.approx(4.0 / 0.06)
    assert read("spp_per_s", ctx) == pytest.approx(4 * 3 / 0.06)
    assert read("setup_s", ctx) == 12.5


def test_p95_is_the_nearest_rank_over_every_frame():
    # 100 frames: 94 of 10 ms, 6 of 50 ms: the 95th is a slow one
    gaps = [0.010] * 94 + [0.050] * 6
    stamps, t = [], 0.0
    for g in gaps:
        t += g
        stamps.append(t)
    ctx = ctx_of(stamps, [1] * 100, [1] * 100)
    assert read("frame_ms_p95", ctx) == pytest.approx(50.0)
    ctx = ctx_of(stamps[:-2], [1] * 98, [1] * 98)  # 4 slow of 98
    assert read("frame_ms_p95", ctx) == pytest.approx(10.0)
    # a line of 16 frames counts 16 intervals of its sixteenth
    ctx = ctx_of([0.16, 0.32], [1, 1], [16, 16])
    assert read("frame_ms_p95", ctx) == pytest.approx(10.0)


def test_a_stall_moves_the_rate_and_the_tail():
    steady = [0.011 * (i + 1) for i in range(200)]
    stalled, t = [], 0.0
    for i in range(200):  # every tenth frame waits 40 ms on the host
        t += 0.011 + (0.040 if i % 10 == 0 else 0.0)
        stalled.append(t)
    a = ctx_of(steady, [10 ** 7] * 200, [1] * 200)
    b = ctx_of(stalled, [10 ** 7] * 200, [1] * 200)
    assert read("mrays_per_s", b) < 0.8 * read("mrays_per_s", a)
    assert read("frame_ms_p95", b) > 4 * read("frame_ms_p95", a)


def timeline():
    """A 10 ms window (us): kernels 0-4 ms and 5-8 ms, a copy 3-4.5 ms
    (overlapping), a kernel outside the window; host ops over the gaps."""
    return {
        "window": (1000.0, 11000.0),
        "device": sorted([
            (1000.0, 5000.0, "void render_kernel<0>(Args)"),
            (4000.0, 5500.0, "Memcpy HtoD"),
            (6000.0, 9000.0, "void render_kernel<0>(Args)"),
            (12000.0, 13000.0, "void render_kernel<0>(Args)"),
        ]),
        "host": [(5400.0, 6100.0, "aten::cat"),
                 (5450.0, 5900.0, "cudaStreamSynchronize"),
                 (8000.0, 11000.0, "save")],
    }


def test_idle_share_from_a_synthetic_timeline():
    data = timeline()
    busy, window = trace_events.busy(data)
    assert busy == pytest.approx(0.0075)  # 1-5.5 ms and 6-9 ms
    assert window == pytest.approx(0.010)
    ctx = ctx_of([0.01], [1], [2], trace=data)
    assert read("device_idle_pct", ctx) == pytest.approx(25.0)
    assert read("kernel_ms_per_frame", ctx) == pytest.approx(7.0 / 2)
    gaps = trace_events.breakdown(data)["idle_gaps"]
    assert gaps[0] == ["save", pytest.approx(0.002)]
    assert gaps[1] == ["cudaStreamSynchronize", pytest.approx(0.0005)]


def test_host_gap_and_roofline_from_a_synthetic_timeline():
    data = timeline()
    ctx = ctx_of([0.01], [10 ** 6], [2], trace=data)
    assert read("host_gap_ms_per_frame", ctx) == pytest.approx((10 - 7) / 2)
    ctx["counts"] = {"ops": 670.0, "segments": 1}  # 670 ops a segment
    peaks = json.loads((BENCH / "peaks.json").read_text())
    least = 670.0 * 1e6 / peaks["fp32_flops"]
    assert read("megakernel_roofline", ctx) == pytest.approx(
        100 * least / 0.007)


def test_a_split_name_reads_its_quantity():
    data = timeline()
    ctx = ctx_of([0.01], [1], [2], trace=data)
    assert read("kernel_ms_per_frame.interactive", ctx) == read(
        "kernel_ms_per_frame", ctx)


def test_readers_find_nothing_without_a_trace():
    ctx = ctx_of([0.01], [1], [1])
    for name in ("device_idle_pct", "kernel_ms_per_frame",
                 "megakernel_roofline", "host_gap_ms_per_frame"):
        assert read(name, ctx) is None
