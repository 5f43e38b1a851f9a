"""The readers of the program's spans on a synthetic timeline: spans and
render kernels on one clock, clipped to the window."""

import pytest

import run

SPAN_METRICS = ("launch_host_ms_per_frame", "readback_ms_per_frame",
                "wait_after_kernel_ms_per_frame")


def ctx_of(trace, frames=2):
    return dict(trace=trace, frames=frames)


def read(name, ctx):
    return run.load_reader(name).read(ctx)


def timeline():
    """A 20 ms window (us) of two viewer frames. Frame 1's launch starts
    before the window and its wait outlasts its kernel by 0.4 ms; frame
    2's wait starts 0.5 ms after its kernel ended; a read-back straddles
    the window's end; a frame after the window counts nothing."""
    return {
        "window": (1000.0, 21000.0),
        "device": sorted([
            (1600.0, 9000.0, "void render_kernel<0>(Args)"),
            (9000.0, 9300.0, "void at::native::reduce_kernel<512>"),
            (10700.0, 19000.0, "void render_kernel<0>(Args)"),
            (22000.0, 23000.0, "void render_kernel<0>(Args)"),
        ]),
        "host": [
            (500.0, 1500.0, "wrapper.launch"),
            (900.0, 1400.0, "wrapper.tables"),
            (3000.0, 9400.0, "driver.wait"),
            (3100.0, 9390.0, "cudaStreamSynchronize"),
            (9400.0, 9700.0, "driver.stats"),
            (10000.0, 10600.0, "wrapper.launch"),
            (10100.0, 10400.0, "aten::cat"),
            (19500.0, 19800.0, "driver.wait"),
            (19800.0, 20100.0, "driver.stats"),
            (20900.0, 21500.0, "driver.stats"),
            (21600.0, 22000.0, "wrapper.launch"),
            (22100.0, 23100.0, "driver.wait"),
            (23100.0, 23400.0, "driver.stats"),
        ],
    }


def test_launch_host_sums_the_wrappers_spans_in_the_window():
    # 0.5 ms of the first launch lies in the window, 0.6 ms of the second
    assert read("launch_host_ms_per_frame", ctx_of(timeline())) == \
        pytest.approx((0.5 + 0.6) / 2)


def test_readback_sums_the_stats_spans_in_the_window():
    # two whole read-backs and the 0.1 ms of the third inside the window
    assert read("readback_ms_per_frame", ctx_of(timeline())) == \
        pytest.approx((0.3 + 0.3 + 0.1) / 2)


def test_wait_after_kernel_counts_from_the_kernels_end():
    # frame 1: 9.0 -> 9.4 ms behind its kernel; frame 2: its whole 0.3 ms
    # wait, which starts after its kernel ended
    assert read("wait_after_kernel_ms_per_frame", ctx_of(timeline())) == \
        pytest.approx((0.4 + 0.3) / 2)


def test_wait_after_kernel_takes_the_latest_kernel_before_the_waits_end():
    data = timeline()
    # a second kernel inside frame 1's wait: the wait counts from its end
    data["device"] = sorted(data["device"] + [
        (9100.0, 9200.0, "void render_adaptive<0>(Args)")])
    assert read("wait_after_kernel_ms_per_frame", ctx_of(data)) == \
        pytest.approx((0.2 + 0.3) / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_their_spans(name):
    assert read(name, ctx_of(None)) is None
    no_window = dict(timeline(), window=None)
    assert read(name, ctx_of(no_window)) is None
    # the parent's trace: kernels and torch's operations, no program span
    parent = dict(timeline(), host=[(10100.0, 10400.0, "aten::cat")])
    assert read(name, ctx_of(parent)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_render_kernels(name):
    # a trace of the plain version on the CPU: spans, but no card's frame
    data = dict(timeline(), device=[])
    assert read(name, ctx_of(data)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_match_the_programs_span_names(name):
    """A reader matches its span by a literal name: a rename in the program
    fails here rather than silently reading nothing."""
    from ray_tracing_extended_tpu_torch.utils import profiling

    assert run.load_reader(name).SPAN in profiling.SPANS


def test_span_metrics_are_the_viewers_cell_only():
    for cell in ("rtiow-final.batch", "chess.interactive", "chess.batch"):
        names = {m["name"] for m in run.load_cell(cell)["per_layer"]}
        want = set(SPAN_METRICS) if cell == "chess.interactive" else set()
        assert set(SPAN_METRICS) & names == want, cell
