"""Runs one cell of the port's benchmark and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card. Everything the
run needs is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file that entry names, its traffic mix in
``benchmark/traffic/<traffic>.json``, its limits in
``benchmark/limits/<cell>.json`` and each metric's reader in
``benchmark/metrics/<metric>.py`` (``<quantity>.py`` for a metric split by
cells, ``<quantity>.<cells>``).

A run builds the scene through the port's public makers (the seed draws
the first frame index, so the random streams), warms up the cell's launches,
then measures one call of ``progressive.render_progressive`` as the
``render`` command makes it (``frames``, ``batch``, a metrics logger, a
checkpoint it resumes from): the window runs from the call to its last
metrics line, which follows the last frame's sync. With ``--trace 1`` the
window runs under ``utils.profiling.trace`` and the line carries the
per-layer metrics instead of the end-to-end ones. After the window the
plain reference (``reference.py``) traces a sample of the window's pixels
through every frame, and of its (pixel, frame) pairs, and decides
``correct`` (``checks``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the benchmark's modules, then the checkout's root, where the program is
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import reference  # noqa: E402  (the benchmark's own; no program import)

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracing_extended_tpu")
# the check's samples: pixels traced through every frame of the window, on
# a grid of strata; (pixel, frame) pairs for the segment total
IMAGE_STRATA = (16, 16)
SEGMENT_PAIRS = 1 << 18
# elements of the reference's largest (rays x primitives) temporary
PAIR_ELEMENTS = 1 << 25
WARM_SECONDS = 1.0
# a compared number that is not finite, as the largest float (JSON has no inf)
NOT_FINITE = sys.float_info.max


def process_start() -> float:
    """The process's start on the wall clock (Linux), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and limits, and
    the metrics of ``BENCHMARK.json`` that it reports."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = root / HERE.name
    config = load_json(root / conf["file"])
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(name=name, cell=cell, config=config, traffic=traffic,
                limits=limits, end_to_end=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]))


def draws(seed: int) -> dict:
    """What the seed decides: the first frame index, and with it every
    random stream of the window, and the check's samples' generator. The
    work stays the same from seed to seed: a scene drawn at random (RTIOW's
    layout) takes the seed its configuration states."""
    rng = np.random.default_rng(seed)
    return dict(frame0=int(rng.integers(1, 1 << 16)),
                rng=np.random.default_rng(rng.integers(0, 2 ** 63)))


def config_sizes(cell: dict, shrink: dict | None) -> dict:
    sizes = dict(cell["config"]["render"])
    sizes.update(shrink or {})
    return sizes


def program_scene(cell: dict, device, shrink=None):
    """The cell's scene, camera and config through the port's makers."""
    sc = cell["config"]["scene"]
    sizes = config_sizes(cell, shrink)
    if sc["kind"] == "rtiow_final":
        from ray_tracing_extended_tpu_torch.models.presets import \
            rtiow_final_scene

        scene, cam, cfg = rtiow_final_scene(
            width=sizes["width"], height=sizes["height"],
            max_bounce=sizes["max_bounce"], spp=sizes["spp"],
            seed=sc["layout_seed"], device=device)
    elif sc["kind"] == "json":
        from ray_tracing_extended_tpu_torch import load_json_scene

        scene, cam, cfg = load_json_scene(
            HERE / sc["file"], overrides=dict(
                width=sizes["width"], height=sizes["height"],
                max_bounce=sizes["max_bounce"], spp=sizes["spp"]),
            device=device)
    else:
        raise SystemExit(f"unknown scene kind {sc['kind']!r}")
    return scene, cam, cfg


def reference_scene(cell: dict):
    """The cell's scene and camera rebuilt from the raw inputs."""
    sc = cell["config"]["scene"]
    if sc["kind"] == "rtiow_final":
        return reference.rtiow_final(sc["layout_seed"])
    scene, cam, _ = reference.json_scene(HERE / sc["file"])
    return scene, cam


class Clock:
    """The metrics logger the window's call writes to: a timestamp on the
    benchmark's clock, the frames and the segments of each line. Closes
    the traced window's span at the line that completes ``frames``."""

    def __init__(self, frames: int = 0, span=None):
        self.frames, self.span = frames, span
        self.stamps, self.segments, self.batched = [], [], []

    def log(self, m) -> None:
        self.stamps.append(time.perf_counter())
        self.segments.append(int(m.rays))
        self.batched.append(int(m.extra.get("batched_frames", 1)))
        if self.span is not None and sum(self.batched) >= self.frames:
            self.span.__exit__(None, None, None)
            self.span = None

    def close(self) -> None:
        pass


def warm_up(render, scene, cam, cfg, batch: int, sync) -> float:
    """Runs the cell's launches until a call of at least ``WARM_SECONDS``
    -> frames a second of the last call."""
    frames = 2 * batch
    render(scene, cam, cfg, frames=frames, batch=batch, metrics=Clock())
    sync()
    while True:
        t0 = time.perf_counter()
        render(scene, cam, cfg, frames=frames, batch=batch, metrics=Clock())
        sync()
        dt = time.perf_counter() - t0
        if dt >= WARM_SECONDS or frames >= 1 << 16:
            return frames / dt
        frames *= 2


def image_pixels(w: int, h: int, rng, strata=IMAGE_STRATA) -> np.ndarray:
    """One pixel drawn in each cell of a grid of strata."""
    sx, sy = strata
    xs = np.linspace(0, w, sx + 1).astype(int)
    ys = np.linspace(0, h, sy + 1).astype(int)
    pix = []
    for j in range(sy):
        for i in range(sx):
            x = rng.integers(xs[i], max(xs[i + 1], xs[i] + 1))
            y = rng.integers(ys[j], max(ys[j + 1], ys[j] + 1))
            pix.append(min(y, h - 1) * w + min(x, w - 1))
    return np.array(pix, np.int64)


def segment_pairs(n_pixels: int, frames: int, rng, pairs=SEGMENT_PAIRS):
    """(pixel, frame offset, (pixel, frame) pairs each stands for): one
    pixel drawn in each of ``pairs`` runs of the pixel index, with a frame
    drawn from the window's; every pair once where the window has no more
    than ``pairs``."""
    if n_pixels * frames <= pairs:
        pix = np.repeat(np.arange(n_pixels), frames)
        return pix, np.tile(np.arange(frames), n_pixels), np.ones_like(pix)
    pairs = min(pairs, n_pixels)
    edges = np.linspace(0, n_pixels, pairs + 1).astype(np.int64)
    size = np.diff(edges)
    pix = edges[:-1] + (rng.random(pairs) * size).astype(np.int64)
    return pix, rng.integers(0, frames, pairs), size * frames


def lane_block(tracer) -> int:
    return max(256, PAIR_ELEMENTS // max(
        tracer.sph_c.shape[0] + tracer.tri_a.shape[0], 1))


def reference_image(tracer, pix, frame0: int, frames: int) -> np.ndarray:
    """The running average at pixels ``pix`` after frames ``frame0 ..
    frame0 + frames - 1`` folded into zeros, by ``tracer`` -> (P, 3)."""
    import torch

    lanes_pix = torch.as_tensor(np.repeat(pix, frames))
    lanes_frame = torch.as_tensor(np.tile(np.arange(frame0, frame0 + frames),
                                          len(pix)))
    means, _ = tracer.render_lanes(lanes_pix, lanes_frame, lane_block(tracer))
    means = means.float().cpu().numpy().reshape(len(pix), frames, 3)
    return reference.fold(range(frame0, frame0 + frames),
                          means.transpose(1, 0, 2),
                          np.zeros((len(pix), 3), np.float32), tracer.clamp)


def image_gap(program: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap between two images at the sampled pixels, over the
    reference's mean there; ``NOT_FINITE`` where either is not finite."""
    program = np.asarray(program, np.float32)
    if not (np.isfinite(program).all() and np.isfinite(ref).all()):
        return NOT_FINITE
    scale = float(np.abs(ref).mean()) or 1.0
    return float(np.abs(program - ref).max() / scale)


def reference_segments(tracer, frame0: int, frames: int, rng,
                       counts=None) -> float:
    """The window's segments estimated from ``SEGMENT_PAIRS`` (pixel,
    frame) pairs, one in each run of the pixel index."""
    import torch

    sp, sf, size = segment_pairs(tracer.w * tracer.h, frames, rng)
    _, segs = tracer.render_lanes(torch.as_tensor(sp),
                                  torch.as_tensor(sf + frame0),
                                  lane_block(tracer), counts)
    return float((segs.cpu().numpy() * size).sum())


def reference_check(d, tracer, frames: int, program_pixels,
                    program_segments: int, pix_img, counts=None) -> dict:
    """The numbers ``correct`` compares: ``image_gap`` (``image_gap`` of
    the program's accumulated image and the reference's at the sampled
    pixels) and ``segment_gap``, the program's window segments against
    the reference's estimate, relative."""
    ref = reference_image(tracer, pix_img, d["frame0"], frames)
    estimate = reference_segments(tracer, d["frame0"], frames, d["rng"],
                                  counts)
    return dict(image_gap=image_gap(program_pixels, ref),
                segment_gap=abs(program_segments - estimate) / max(estimate,
                                                                   1.0))


def load_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a
    split name ``<quantity>.<cells>`` without a file of its own, the
    quantity's ``metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(metrics: list, ctx: dict) -> dict:
    """Each metric's reader on ``ctx``; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", shrink: dict | None = None, root: Path = ROOT,
             keep: bool = False) -> dict:
    """One run of cell ``name`` on ``device`` -> the result dict (with
    ``keep``, also what the check compared, under ``_state``). ``shrink``
    overrides the configuration's sizes: for the tests on the CPU only."""
    import torch

    from ray_tracing_extended_tpu_torch import progressive
    from ray_tracing_extended_tpu_torch.utils import checkpoint as ckpt
    from ray_tracing_extended_tpu_torch.utils import profiling

    cell = load_cell(name, root)
    d = draws(seed)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    scene, cam, cfg = program_scene(cell, dev, shrink)
    batch = int(cell["traffic"]["batch"])
    render = progressive.render_progressive
    rate = warm_up(render, scene, cam, cfg, batch, sync)
    frames = max(batch, int(round(rate * seconds / batch)) * batch)

    work = Path(tempfile.mkdtemp(prefix="bench_"))
    resume = work / "resume.npz"
    ckpt.save(resume, np.zeros((cfg.height, cfg.width, 3), np.float32),
              d["frame0"], ckpt.state_hash(scene, cam, cfg))
    # the profiler starts before the window (its start takes seconds)
    prof = profiling.trace(str(work / "trace")) if trace else None
    if prof is not None:
        prof.__enter__()
    span = torch.profiler.record_function("benchmark.window") if trace else None
    clock = Clock(frames, span)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = time.time() - T_START
    if span is not None:
        span.__enter__()
    try:
        accum = render(scene, cam, cfg, frames=frames, batch=batch,
                       metrics=clock, checkpoint_path=str(resume),
                       resume=True)
        sync()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = clock.stamps[-1] - t0
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    done = sum(clock.batched)
    pix_img = image_pixels(cfg.width, cfg.height, d["rng"])
    program_pixels = accum.reshape(-1, 3)[torch.as_tensor(pix_img).to(
        accum.device)].float().cpu().numpy()
    program_segments = sum(clock.segments)
    del accum, scene
    trace_data = None
    if trace:
        import trace_events

        trace_data = trace_events.load(work / "trace" / "trace.json")
    for f in sorted(work.rglob("*"), reverse=True):
        f.unlink() if f.is_file() else f.rmdir()
    work.rmdir()
    if cuda:
        torch.cuda.empty_cache()

    rscene, rcam = reference_scene(cell)

    sizes = config_sizes(cell, shrink)

    def tracer(dtype):
        # the configuration's statement, not the program's config
        return reference.Tracer(rscene, rcam, sizes["width"], sizes["height"],
                                sizes["max_bounce"], sizes["spp"], dev, dtype,
                                clamp=sizes["saturate"])

    t_check = time.perf_counter()
    counts = {"ops": 0.0, "segments": 0}
    d_check = dict(d, rng=np.random.default_rng(d["rng"].integers(0, 2 ** 63)))
    checks = reference_check(d_check, tracer(torch.float32), done,
                             program_pixels, program_segments, pix_img,
                             counts)
    check_s = time.perf_counter() - t_check
    limits = cell["limits"]
    correct = (done == frames and all(
        checks[k] <= limits[k] for k in ("image_gap", "segment_gap")))
    scene_bytes = sum(a.nbytes for a in (
        rscene.sph_center, rscene.sph_radius, rscene.tri_pos, rscene.tri_nrm,
        *rscene.materials.values()))
    ctx = dict(cell=cell, cfg=cfg, frames=done, window_s=window_s,
               t0=t0, stamps=clock.stamps, batched=clock.batched,
               segments=program_segments, setup_s=setup_s, trace=trace_data,
               counts=counts, batch=batch, scene_bytes=scene_bytes, root=HERE)
    metrics = read_metrics(cell["per_layer"] if trace else cell["end_to_end"],
                           ctx)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": frames,
              "failed": frames - done, "metrics": metrics,
              "device": device_info}
    if trace_data is not None:
        busy, span_s = trace_events.busy(trace_data)
        device_info["busy_s"] = busy
        device_info["window_s"] = span_s
        result["breakdown"] = trace_events.breakdown(trace_data)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in ("image_gap", "segment_gap")}
    intervals = sorted(np.diff([t0] + clock.stamps) * 1e3)
    result["_notes"] = (
        f"window {window_s:.3f} s, {done} frames in {len(intervals)} lines; "
        f"line interval median {intervals[len(intervals) // 2]:.3f} ms, "
        f"max {intervals[-1]:.3f} ms; check {check_s:.1f} s")
    if keep:
        # what the control (control.py) reruns in the program's place
        result["_state"] = dict(pix_img=pix_img, frames=done, sizes=sizes,
                                frame0=d["frame0"], rscene=rscene, rcam=rcam,
                                device=dev, limits=limits,
                                program_pixels=program_pixels)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    try:
        import torch
    except ImportError as e:
        print(f"benchmark: no PyTorch ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: this cell needs 1 CUDA device; none is available",
              file=sys.stderr)
        return 2
    try:
        import ray_tracing_extended_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program under test is missing ({e})",
              file=sys.stderr)
        return 2
    # one intra-op thread: the host's side of the window is the program's
    # loop and small tensors, and idle worker threads only add jitter
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, which the port must not",
              file=sys.stderr)
        return 3
    print(result.pop("_notes"), file=sys.stderr)
    print(card_line(), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
