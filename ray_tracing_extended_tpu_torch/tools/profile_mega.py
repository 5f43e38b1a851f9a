"""Where a frame of the path-trace kernel goes: the closest hit, the
winner's fetch, and the rest.

Counterpart of the repo's ``tools/profile_mega.py``. It renders one
configuration, by default that tool's (the RTIOW final scene, 1920x1080,
16 spp, 4 bounces), through three instantiations of
``csrc/megakernel.cu``, interleaved rep by rep:

  full           the production instantiation
  dup_intersect  each segment's closest hit done twice (kDupIntersect)
  dup_fetch      each segment's winner fetch done twice (kDupFetch)

and prints that tool's lines: each variant's frame ms (median and range
over the reps) with its segment count, then ``intersect ~ di - full``,
``fetch ~ df - full`` and ``other ~ 3 full - di - df``, each with its share
of ``full``. A delta no larger than the spread of ``full`` (its range over
the reps) prints as ``within spread``. The second pass can overlap the
first one's memory waits, so a delta is the part's marginal cost, not its
slice of the timeline; where a dup instantiation spills more than its
production twin (``ptxas -v``), an upper bound. The knobs change no image:
the first call of each variant is held to ``full``'s bit for bit (image,
per-pixel segments, total).

Time: CUDA events around one launch of K = 4 frames folded into a seeded
accumulator (frame0 = 1), a frame's ms the launch's over K, as PERF.md's
kernel table is timed. Runs on the card::

    python -m ray_tracing_extended_tpu_torch.tools.profile_mega
    python -m ray_tracing_extended_tpu_torch.tools.profile_mega \\
        --scene preset:cornell --adaptive-spp

``--scene`` takes ``preset:rtiow|cornell|mesh`` (the presets at their own
sizes; RTIOW at 16 spp and 4 bounces) or a ``.json`` scene (its shipped
settings); ``--width``, ``--height``, ``--spp`` and ``--max-bounce``
override them. ``--device cpu`` rehearses the same steps through the plain
version (``render_frames_plain`` with the same knobs) at a size the caller
gives; its times are the host's and mean nothing::

    python -m ray_tracing_extended_tpu_torch.tools.profile_mega \\
        --device cpu --width 32 --height 18
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import torch

SEED = 0
# (label, the knob of render_frames_mega), in the order of each rep
VARIANTS = (("full", None), ("dup_intersect", "dup_intersect"),
            ("dup_fetch", "dup_fetch"))


def decompose(full, dup_intersect, dup_fetch) -> dict:
    """The split of a frame from each variant's frame ms over the reps:
    each variant's median and range; ``intersect`` (di - full), ``fetch``
    (df - full) and ``other`` (3 full - di - df) from the medians, each
    with its share of full's median; ``spread``, full's range; and, for
    the two deltas, whether they lie within it (``|delta| <= spread``)."""
    out = {}
    for name, ms in (("full", full), ("dup_intersect", dup_intersect),
                     ("dup_fetch", dup_fetch)):
        out[name] = dict(median=statistics.median(ms), min=min(ms),
                         max=max(ms))
    f = out["full"]["median"]
    di = out["dup_intersect"]["median"]
    df = out["dup_fetch"]["median"]
    spread = out["full"]["max"] - out["full"]["min"]
    out["spread"] = spread
    for part, ms in (("intersect", di - f), ("fetch", df - f),
                     ("other", 3 * f - di - df)):
        out[part] = dict(ms=ms, share=ms / f)
    for part in ("intersect", "fetch"):
        out[part]["within_spread"] = abs(out[part]["ms"]) <= spread
    return out


def report(split: dict, segments: dict, frames: int) -> list[str]:
    """The JAX tool's lines from ``decompose``'s split and each variant's
    segments over a launch of ``frames`` frames."""
    lines = [
        f"{name:14s} {split[name]['median']:8.3f} ms "
        f"({split[name]['min']:.3f}-{split[name]['max']:.3f})  "
        f"segs={segments[name]} in {frames} frames"
        for name, _ in VARIANTS
    ]

    def part(name):
        p = split[name]
        if p.get("within_spread"):
            return f"{name} ~ within spread"
        return f"{name} ~ {p['ms']:.3f} ms ({100 * p['share']:.0f}%)"

    lines.append(", ".join(part(n) for n in ("intersect", "fetch", "other")))
    return lines


def profile(scene, camera, cfg, reps: int = 7, frames: int = 4) -> dict:
    """Times the three variants on ``scene`` at ``cfg``, interleaved rep by
    rep after one call each that holds the dup variants' outputs to
    full's bit for bit (raises if they differ). -> ``decompose``'s split
    with ``ms`` (each variant's frame ms a rep), ``segments`` (a launch's),
    ``frames``, ``reps``, ``device`` and ``lines`` (``report``)."""
    from ..kernels.megakernel import render_frames_mega

    dev = scene.device
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    acc0 = 2.0 * torch.rand((cfg.height, cfg.width, 3), generator=gen,
                            device=dev)

    def call(probe):
        return render_frames_mega(scene, camera, cfg, 1, frames, accum=acc0,
                                  probe=probe)

    ref = call(None)
    segments = {"full": int(ref[1])}
    for name, probe in VARIANTS[1:]:
        out = call(probe)
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
                and int(out[1]) == int(ref[1])):
            raise RuntimeError(f"{name} changed the image or its segments")
        segments[name] = int(out[1])

    ms = {name: [] for name, _ in VARIANTS}
    for _ in range(reps):
        for name, probe in VARIANTS:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(probe)
                end.record()
                torch.cuda.synchronize(dev)
                ms[name].append(start.elapsed_time(end) / frames)
            else:
                t0 = time.perf_counter()
                call(probe)
                ms[name].append((time.perf_counter() - t0) * 1e3 / frames)
    split = decompose(ms["full"], ms["dup_intersect"], ms["dup_fetch"])
    return dict(split, ms=ms, segments=segments, frames=frames, reps=reps,
                device=torch.cuda.get_device_name(dev) if cuda else str(dev),
                lines=report(split, segments, frames))


def load(spec: str, device, **overrides):
    """A scene for ``--scene`` -> ``(scene, camera, config)``, with the
    config's fields in ``overrides`` (those not None) replaced."""
    from ..models import presets
    from ..scene.json_scene import load_json_scene

    overrides = {k: v for k, v in overrides.items() if v is not None}
    if spec.endswith(".json"):
        return load_json_scene(spec, overrides=overrides, device=device)
    table = {
        "preset:rtiow": lambda: presets.rtiow_final_scene(
            max_bounce=4, spp=16, device=device),
        "preset:cornell": lambda: presets.cornell_box_scene(device=device),
        "preset:mesh": lambda: presets.mesh_scene(device=device),
    }
    if spec not in table:
        raise SystemExit(f"--scene {spec!r}: expected one of "
                         f"{sorted(table)} or a .json scene")
    scene, cam, cfg = table[spec]()
    return scene, cam, dataclasses.replace(cfg, **overrides).validate()


def main(argv=None) -> int:
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(prog="profile_mega",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="preset:rtiow")
    p.add_argument("--adaptive-spp", action="store_true")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--max-bounce", type=int)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--frames", type=int, default=4,
                   help="frames a launch (K)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.reps < 2 or args.frames < 1:
        raise SystemExit("--reps must be at least 2 (a spread), --frames 1")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    scene, cam, cfg = load(
        args.scene, dev, width=args.width, height=args.height, spp=args.spp,
        max_bounce=args.max_bounce,
        adaptive_spp=True if args.adaptive_spp else None)
    res = profile(scene, cam, cfg, args.reps, args.frames)
    where = res["device"] if dev.type == "cuda" else (
        "the CPU: a rehearsal, its times mean nothing")
    print(f"{args.scene} {cfg.width}x{cfg.height}, {cfg.spp} spp, "
          f"{cfg.max_bounce} bounces, "
          f"{'refill' if cfg.adaptive_spp else 'exact'}; K={args.frames} "
          f"frames a launch, {args.reps} reps; on {where}", flush=True)
    for line in res["lines"]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
