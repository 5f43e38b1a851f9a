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
``--super-chunks N`` sets the chunk scan's run length (a value above the
chunk count switches its second level off) on a tree that has one.

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


def _entry(ln: str):
    """The kernel entry a line names, ``render_kernel<geometry,scatter>``
    (``render_kernel<geometry,scatter,global>`` on the global table route
    of a tree that has one, ``...,knobs>`` for refill under the lane knobs),
    or None."""
    m = re.search(r"(render_kernel|render_adaptive)IL\w*?E(\d)EL\w*?E(\d)E", ln)
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_ab needs a CUDA device")

    import ray_tracing_extended_tpu_torch as rtt
    from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
    from ray_tracing_extended_tpu_torch.models import presets

    if args.super_chunks is not None:
        if not hasattr(mk, "SUPER_CHUNKS"):
            raise SystemExit("this tree's chunk scan has no second level")
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
                    e = one["events"]
                    refill["refill_phase_frame_ms"] = [
                        e[0].elapsed_time(e[1]) / K_FRAMES,
                        e[2].elapsed_time(e[3]) / K_FRAMES]
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
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
