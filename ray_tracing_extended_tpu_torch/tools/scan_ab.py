"""Frame times of the path-trace kernel on the scenes its two scans are
judged on, for an A/B of two trees of this package on one card.

It drives only what every tree of the port since the big-mesh slice
offers (the presets, ``load_json_scene``, ``render_frames_and_accumulate``,
``kernels.megakernel.KERNEL``), so the same file measures an older
checkout: run it by path with ``PYTHONPATH`` set to the tree to measure,

    PYTHONPATH=<tree> python <this file> --label parent --out a.jsonl

and compare two trees only within one run of commands on one card, in turns
(parent, change, change, parent). Per configuration it prints one JSON line:
the K = 4 frame fold from a seeded accumulator (frame0 = 1), its CUDA-event
time a frame (median and least of ``--reps`` calls after a warm-up), the
segment total and the image mean; first a line with the card, the
registers and spill bytes of every kernel entry from ``ptxas -v``, and a
digest of each entry's SASS (``cuobjdump -sass``, branch labels numbered
within the entry), equal on two trees exactly where their machine code is.

Configurations: RTIOW 1920x1080, 16 spp, 4 bounces; Chess at its shipped
settings (1280x720, 3 spp, 15 bounces); Cornell 512x512, 4 spp, 8 bounces;
the 70k-triangle mesh 1280x720, 1 spp, 4 bounces; each with exact spp and
with adaptive refill, each of those with the Box-Muller and the fast
scatter; and the RTIOW rule over wider grids (``models/wide_scenes.py`` of
this file's tree, built through the measured tree's presets: ``wide14k``,
14,401 spheres, and ``wide100k``, 99,857; RTIOW's camera and config),
exact and refill with the Box-Muller scatter; and ``rtiow_global``, RTIOW
as above with its tables forced onto the global route
(``render_frames_mega(..., tables="global")``), in the four modes.
``--super-chunks N`` sets the chunk scan's run length on a tree that has
one: on a tree with ``super_levels`` the F of both box levels (the depth
still follows from the chunk count; a value at or above it switches the
levels off), on an older tree the one level's.

A refill line also holds the samples a pixel started in a stats frame
(``started_samples_per_pixel``: its bounce histogram's first bin over the
pixels; spp/s is that over a frame's seconds) and, on a tree whose
``render_frames_mega`` takes ``phase_one``, each of the call's two launches'
CUDA-event ms a frame (``refill_phase_frame_ms``).

Each line also holds the host gap of a one-frame call
(``host_gap_ms_median``): a lone call's wall time to
``torch.cuda.synchronize()`` (``one_frame_wall_ms``) less the CUDA-event
time of the same call queued behind the K-frame one
(``one_frame_device_ms``: the card is busy while the host prepares it, so
the events hold its device work only; events around a lone call would
hold the host's time too, the card idle between them).

``--knobs`` adds, on RTIOW and Cornell, refill under the TPU kernel's lane
knobs in ``KNOB_TIMINGS``' settings (pixels a lane, phases, paired), Box-
Muller scatter: a lane's pixels paired by the default refill's K = 4 segment
map of the same call, as ``render_progressive`` pairs each batch by the
last; each line with its three launches' ms a frame (phase 1, the lane pass,
phase 2), the lane pass's device ms alone (``lane_pass_ms``) and, on a tree
with a lane list, its phase 2 warps (``refill_warp_counts``). ``--knob-digests`` prints instead the digests of
refill's outputs under ``KNOB_DIGEST_SETTINGS`` on RTIOW 480x270 and Cornell
256x256 (``knob_digests``), which ``chip_smoke.py`` holds a tree to.

``--summarize FILE`` prints, without a card, the A/B of the lines that runs of
several trees in turns appended to FILE (``--out``) against ``--base``'s
(``summarize``): medians, ranges, ratios and pairs won.

``--images DIR`` keeps each configuration's folded image as
``DIR/<label>_<configuration>.npy``; with ``--against LABEL`` each line
also says how many pixels differ from that label's image of the same
configuration (``pixels_moved``) and by how much at most.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
K_FRAMES = 4
# refill's lane-knob settings --knobs times: (pixels a lane, phases, paired)
KNOB_TIMINGS = ((2, 1, True), (4, 1, True), (2, 2, True), (2, 1, False))
# the settings --knob-digests digests (chip_smoke.py's KNOB_SETTINGS)
KNOB_DIGEST_SETTINGS = ((2, 1, False), (4, 1, False), (1, 2, False),
                        (2, 2, False), (2, 1, True))


def _digest(*tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def knob_tag(ppl: int, phases: int, paired: bool) -> str:
    return f"ppl{ppl}_ph{phases}" + ("_paired" if paired else "")


def knob_scenes(presets, device=None) -> dict:
    """The scenes whose refill outputs ``--knob-digests`` digests."""
    kw = {} if device is None else dict(device=device)
    return {
        "rtiow": lambda: presets.rtiow_final_scene(
            width=480, height=270, max_bounce=4, spp=16, **kw),
        "cornell": lambda: presets.cornell_box_scene(
            width=256, height=256, max_bounce=8, spp=4, **kw),
    }


def phase_ms(mk, events, n_frames: int) -> list:
    """A refill call's launches' ms a frame from ``phase_one``'s events:
    phase 1, what lies between the phases, phase 2 (``mk.phase_ms``). A
    tree before the lane list records four events, and what lies between
    its phases holds the copies made for ``phase_one`` too."""
    if hasattr(mk, "phase_ms"):
        return mk.phase_ms(events, n_frames)
    e = events
    return [e[0].elapsed_time(e[1]) / n_frames,
            e[1].elapsed_time(e[2]) / n_frames,
            e[2].elapsed_time(e[3]) / n_frames]


def lane_pass_ms(mk, scene, cfg, slots, costs, reps=50) -> float:
    """The lane pass's device ms (``mk.lane_pass_ms``). A tree before the
    lane list takes no list, and a zeroed ``tile_max``."""
    if hasattr(mk, "lane_pass_ms"):
        return mk.lane_pass_ms(scene, cfg, slots, costs, reps)
    ppl, phases = mk.refill_knobs(scene, cfg)
    h, w = slots.shape
    ts = mk.refill_tile_size(scene, cfg)
    perm = (None if costs is None
            else mk.pair_perm(costs, w, h, ts, ppl, 0, h).contiguous())
    resume = torch.empty_like(slots)
    tile_max = torch.zeros(-(-h // ts) * -(-w // ts), dtype=torch.int32,
                           device=slots.device)

    def call():
        mk.KERNEL.lane_pass(slots, resume, tile_max, w, h, ts, ppl, phases,
                            (0, h), perm)

    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        call()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _entry(ln: str):
    """The kernel entry a line names, ``render_kernel<geometry,scatter>``
    (``render_kernel<geometry,scatter,global>`` on the global table route
    of a tree that has one, ``...,knobs>`` for refill under the lane knobs,
    ``render_listed<geometry,scatter>`` for its phase 2 over the lane list),
    or None."""
    m = re.search(r"(render_kernel|render_adaptive|render_listed)IL\w*?E(\d)EL"
                  r"\w*?E(\d)E", ln)
    if not m:
        return None
    route = ",global" if re.search(r"TablesE1E", ln) else ""
    knobs = ",knobs" if re.search(r"TablesE[01]ELb1E", ln) else ""
    return f"{m.group(1)}<{m.group(2)},{m.group(3)}{route}{knobs}>"


def _ptxas(log: str) -> dict:
    """{entry: [registers, spill store bytes, spill load bytes]} from
    ``ptxas -v``; an entry's stack line is the one right after its
    "Function properties" line."""
    out, entry, own = {}, None, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = _entry(ln)
            if entry:
                out[entry] = [None, None, None]
        elif "Function properties for" in ln:
            own = entry is not None and _entry(ln) == entry
        elif entry and (r := re.search(r"Used (\d+) registers", ln)):
            out[entry][0] = int(r.group(1))
        elif entry and own and "bytes spill stores" in ln:
            out[entry][1] = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            out[entry][2] = int(re.search(r"(\d+) bytes spill loads", ln).group(1))
    return out


def _sass(library: Path) -> dict:
    """{entry: sha256 prefix of its SASS} from ``cuobjdump -sass`` beside
    nvcc (None without one); each ``.L_x_N`` branch label is renumbered in
    its order within the entry, so the digest does not depend on the
    entries around it."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tool = Path(nvcc).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    bodies, entry = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            entry = _entry(ln)
            if entry:
                bodies[entry] = []
        elif entry:
            bodies[entry].append(ln.strip())
    out = {}
    for entry, lines in bodies.items():
        labels = {}
        body = re.sub(r"\.L_x_\d+",
                      lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"),
                      "\n".join(lines))
        out[entry] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return out


def _wide_scenes():
    """``models/wide_scenes.py`` of this file's tree, loaded by its path: it
    builds through the ``presets`` module it is given, so a measured tree
    that lacks it gets the same scene."""
    path = Path(__file__).resolve().parents[1] / "models" / "wide_scenes.py"
    spec = importlib.util.spec_from_file_location("_scan_ab_wide_scenes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def summarize(path, base: str) -> list:
    """The A/B of the lines in ``path`` (``--out`` of runs of several trees in
    turns): for each configuration and each label but ``base``, the median
    and range of the runs' median frame ms, the ratio of the medians to
    ``base``'s, and how many of the pairs (the k-th run of each, in file
    order) the label won; for the knob lines also the medians of the
    launches' ms a frame (phase 1, the lane pass, phase 2) and of the lane
    pass's device ms alone."""
    runs = {}
    for line in Path(path).read_text().splitlines():
        d = json.loads(line)
        if d.get("phase") == "frames":
            config = (f"{d['scene']}_{'refill' if d['adaptive_spp'] else 'exact'}"
                      f"{'_fast' if d['fast_scatter'] else ''}")
        elif d.get("phase") == "knobs":
            config = d["config"]
        else:
            continue
        runs.setdefault(config, {}).setdefault(d["label"], []).append(d)
    out = []
    for config, by_label in runs.items():
        ref = [d["frame_ms_median"] for d in by_label.get(base, [])]
        for label, ds in by_label.items():
            if label == base or not ref:
                continue
            ms = [d["frame_ms_median"] for d in ds]
            row = dict(config=config, base=base, label=label,
                       base_med=statistics.median(ref),
                       base_rng=[min(ref), max(ref)],
                       label_med=statistics.median(ms),
                       label_rng=[min(ms), max(ms)],
                       ratio=statistics.median(ms) / statistics.median(ref),
                       pairs=min(len(ms), len(ref)),
                       pairs_won=sum(m < r for m, r in zip(ms, ref)))
            for who, group in ((base, by_label[base]), (label, ds)):
                split = [d["refill_launch_frame_ms"] for d in group
                         if "refill_launch_frame_ms" in d]
                if split:
                    row[f"{who}_launch_ms"] = [statistics.median(x)
                                               for x in zip(*split)]
                lane = [d["lane_pass_ms"] for d in group if "lane_pass_ms" in d]
                if lane:
                    row[f"{who}_lane_pass_ms"] = statistics.median(lane)
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--super-chunks", type=int, default=None)
    ap.add_argument("--only", default=None,
                    help="comma-separated scene names (rtiow, rtiow_global, "
                    "chess, cornell, mesh, wide14k, wide100k)")
    ap.add_argument("--out", default=None, help="append the lines to this file")
    ap.add_argument("--images", default=None,
                    help="keep each configuration's image in this directory")
    ap.add_argument("--against", default=None,
                    help="count the pixels that differ from this label's images")
    ap.add_argument("--knobs", action="store_true",
                    help="also refill under the lane knobs (KNOB_TIMINGS)")
    ap.add_argument("--knob-digests", action="store_true",
                    help="print the knob outputs' digests and nothing else")
    ap.add_argument("--summarize", default=None, metavar="FILE",
                    help="print the A/B of FILE's lines against --base and "
                    "nothing else (no card needed)")
    ap.add_argument("--base", default="parent",
                    help="the label --summarize compares the others with")
    args = ap.parse_args(argv)
    if args.summarize:
        for row in summarize(args.summarize, args.base):
            print(json.dumps(row))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("scan_ab needs a CUDA device")

    import ray_tracing_extended_tpu_torch as rtt
    from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
    from ray_tracing_extended_tpu_torch.models import presets

    if args.super_chunks is not None:
        if not hasattr(mk, "SUPER_CHUNKS"):
            raise SystemExit("this tree's chunk scan has no box level")
        mk.SUPER_CHUNKS = args.super_chunks

    lines = []

    def emit(**fields):
        line = json.dumps({"label": args.label, **fields})
        print(line, flush=True)
        lines.append(line)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.knob_digests:
        emit(phase="knob_digests", gpu=smi,
             package=str(Path(rtt.__file__).parent), digests={
                 name: mk.knob_digests(*make(), KNOB_DIGEST_SETTINGS, SEED)
                 for name, make in knob_scenes(presets).items()})
        return 0
    info = mk.KERNEL.build()
    emit(phase="build", gpu=smi, package=str(Path(rtt.__file__).parent),
         super_chunks=getattr(mk, "SUPER_CHUNKS", None),
         build_s=info.seconds, ptxas=_ptxas(info.log),
         sass=_sass(info.library))

    dev = torch.device("cuda", 0)
    wide = _wide_scenes()
    scenes = {
        "rtiow": lambda: presets.rtiow_final_scene(
            width=1920, height=1080, max_bounce=4, spp=16),
        "chess": lambda: rtt.load_json_scene(
            Path(rtt.__file__).resolve().parent.parent / "scenes" / "chess.json"),
        "cornell": lambda: presets.cornell_box_scene(
            width=512, height=512, max_bounce=8, spp=4),
        "mesh": lambda: presets.mesh_scene(),
        "wide14k": lambda: wide.wide_sphere_scene(
            presets, wide.HALF_PAST_LIMIT, spp=16),
        "wide100k": lambda: wide.wide_sphere_scene(
            presets, wide.HALF_100K, spp=16),
    }
    scenes["rtiow_global"] = scenes["rtiow"]
    images = Path(args.images) if args.images else None
    if images:
        images.mkdir(parents=True, exist_ok=True)
    only = args.only.split(",") if args.only else list(scenes)
    for name in only:
        scene, cam, cfg = scenes[name]()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        acc0 = 2.0 * torch.rand((cfg.height, cfg.width, 3), generator=gen,
                                device=dev)
        modes = ((False, False), (False, True))
        if not name.startswith("wide"):
            modes += ((True, False), (True, True))
        for fast, adaptive in modes:
            vcfg = dataclasses.replace(cfg, adaptive_spp=adaptive,
                                       fast_scatter=fast)

            def call(n_frames=K_FRAMES):
                if name.endswith("_global"):
                    return mk.render_frames_mega(
                        scene, cam, vcfg, 1, n_frames, accum=acc0,
                        tables="global")[:2]
                return rtt.render_frames_and_accumulate(
                    scene, cam, vcfg, acc0, 1, n_frames)

            mk.KERNEL.reset_counts()
            acc, segs = call()
            call(1)
            torch.cuda.synchronize()
            ms, one_wall, one_device = [], [], []
            for _ in range(args.reps):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                again, _ = call()
                ev[1].record()
                # queued behind the K-frame call: the card is busy while the
                # host prepares it, so its events hold its device time only
                ev[2].record()
                call(1)
                ev[3].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]) / K_FRAMES)
                one_device.append(ev[2].elapsed_time(ev[3]))
                t0 = time.perf_counter()
                call(1)
                torch.cuda.synchronize()
                one_wall.append((time.perf_counter() - t0) * 1e3)
            gap = [w - d for w, d in zip(one_wall, one_device)]
            if not torch.equal(acc, again):
                raise RuntimeError(f"{name}: two identical calls differ")
            launches = dict(mk.KERNEL.variant_launches)
            refill = {}
            if adaptive:
                _, _, hist = rtt.render_frame_with_stats(
                    scene, cam, vcfg, 1, bounce_stats=True)
                refill["started_samples_per_pixel"] = (
                    int(hist[0]) / (cfg.width * cfg.height))
                if "phase_one" in inspect.signature(
                        mk.render_frames_mega).parameters:
                    one = {}
                    mk.render_frames_mega(scene, cam, vcfg, 1, K_FRAMES,
                                          accum=acc0.clone(), phase_one=one)
                    torch.cuda.synchronize()
                    refill["refill_phase_frame_ms"] = phase_ms(
                        mk, one["events"], K_FRAMES)[::2]
            moved = {}
            config = (f"{name}_{'refill' if adaptive else 'exact'}"
                      f"{'_fast' if fast else ''}")
            if images:
                img = acc.cpu().numpy()
                np.save(images / f"{args.label}_{config}.npy", img)
                ref = images / f"{args.against}_{config}.npy"
                if args.against and ref.exists():
                    ref = np.load(ref)
                    moved = dict(against=args.against, pixels_moved=int(
                        (img != ref).any(axis=-1).sum()),
                        max_abs_moved=float(np.abs(img - ref).max()))
            emit(phase="frames", scene=name, adaptive_spp=adaptive,
                 fast_scatter=fast,
                 width=cfg.width, height=cfg.height, spp=cfg.spp,
                 max_bounce=cfg.max_bounce, frames=K_FRAMES,
                 frame_ms_median=statistics.median(ms), frame_ms_min=min(ms),
                 frame_ms_all=ms, one_frame_wall_ms=one_wall,
                 one_frame_device_ms=one_device,
                 host_gap_ms_median=statistics.median(gap), segments=int(segs),
                 image_mean=float(acc.mean()),
                 image_mean_f64=float(acc.double().mean()),
                 launches=launches, **refill, **moved)
        if args.knobs and name in ("rtiow", "cornell"):
            knob_lines(mk, name, scene, cam, cfg, acc0, args, images, emit)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def knob_lines(mk, name, scene, cam, cfg, acc0, args, images,
               emit) -> None:
    """``--knobs``: a line a setting of ``KNOB_TIMINGS``, the K = 4 fold
    from ``acc0`` as the other lines time it, paired by the default refill's
    segment map of the same call; the split of one call into its launches
    from ``phase_one``'s events."""
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    costs = mk.render_frames_mega(scene, cam, ad, 1, K_FRAMES, accum=acc0)[2]
    for ppl, phases, paired in KNOB_TIMINGS:
        kcfg = dataclasses.replace(ad, mega_pixels_per_lane=ppl,
                                   mega_phases=phases)
        pc = costs if paired else None

        def call():
            return mk.render_frames_mega(scene, cam, kcfg, 1, K_FRAMES,
                                         accum=acc0, pair_costs=pc)

        mk.KERNEL.reset_counts()
        acc, segs = call()[:2]
        ms = []
        for _ in range(args.reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            again = call()[0]
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]) / K_FRAMES)
        if not torch.equal(acc, again):
            raise RuntimeError(f"{knob_tag(ppl, phases, paired)}: two "
                               "identical calls differ")
        launches = dict(mk.KERNEL.variant_launches)
        one = {}
        seg_map = mk.render_frames_mega(scene, cam, kcfg, 1, K_FRAMES,
                                        accum=acc0.clone(), phase_one=one,
                                        pair_costs=pc)[2]
        torch.cuda.synchronize()
        warps = {}
        if hasattr(mk, "refill_warp_counts"):
            warps["refill_warps"] = mk.refill_warp_counts(
                one["segs"], seg_map, one.get("lane_list"))
        if ppl > 1:
            warps["lane_pass_ms"] = lane_pass_ms(mk, scene, kcfg, one["slots"],
                                                 costs if paired else None)
        config = f"{name}_refill_{knob_tag(ppl, phases, paired)}"
        moved = {}
        if images:
            img = acc.cpu().numpy()
            np.save(images / f"{args.label}_{config}.npy", img)
            ref = images / f"{args.against}_{config}.npy"
            if args.against and ref.exists():
                ref = np.load(ref)
                moved = dict(against=args.against, pixels_moved=int(
                    (img != ref).any(axis=-1).sum()),
                    max_abs_moved=float(np.abs(img - ref).max()))
        emit(phase="knobs", config=config, pixels_per_lane=ppl,
             phases=phases, paired=paired, width=cfg.width,
             height=cfg.height, spp=cfg.spp, max_bounce=cfg.max_bounce,
             frames=K_FRAMES, frame_ms_median=statistics.median(ms),
             frame_ms_min=min(ms), frame_ms_all=ms,
             refill_launch_frame_ms=phase_ms(mk, one["events"], K_FRAMES),
             segments=int(segs), image_mean=float(acc.mean()),
             image_mean_f64=float(acc.double().mean()),
             seg_map_digest=_digest(seg_map), launches=launches, **warps,
             **moved)


if __name__ == "__main__":
    raise SystemExit(main())
