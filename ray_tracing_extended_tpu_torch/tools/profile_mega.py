"""Where a frame of the path-trace kernel goes: the closest hit, the
winner's fetch, and the rest.

Counterpart of the repo's ``tools/profile_mega.py``. It renders one
configuration, by default that tool's (the RTIOW final scene, 1920x1080,
16 spp, 4 bounces), through seven instantiations of
``csrc/megakernel.cu``, interleaved rep by rep:

  full            the production instantiation
  dup_intersect   each segment's closest hit done twice (kDupIntersect)
  dup_fetch       each segment's winner fetch done twice (kDupFetch)
  stub_intersect  no closest hit: every segment hits the JAX tables' slot 0
                  (kStubIntersect)
  stub_fetch      a hit's fields are constants (kStubFetch)
  stubs           both stubs: the scheduler, shading and RNG only
  no_cull         the closest hit with every gate open (kNoCull)

and prints each variant's frame ms (median and range over the reps) with
its segment count, then two splits, each part with its share of ``full``.
The dup form (the JAX tool's code): ``intersect ~ di - full``, ``fetch ~
df - full`` and ``other ~ 3 full - di - df``; a delta no larger than the
spread of ``full`` (its range over the reps) prints as ``within spread``.
The second pass can overlap the first one's memory waits, so a delta is
the part's marginal cost, not its slice of the timeline; where a dup
instantiation spills more than its production twin (``ptxas -v``), an
upper bound. The stub form (the JAX tool's docstring): ``intersect ~ full
- stub_intersect``, ``fetch ~ full - stub_fetch`` and ``other ~ stubs``.
A stub changes the rays' paths, so the stub frames trace other segments
than ``full`` (their counts are printed beside them): a rough split, for
direction. Last ``culls save ~ no_cull - full``. The dup knobs and
``no_cull`` change no image: the first call of each is held to ``full``'s
bit for bit (image, per-pixel segments, total). Under the JAX package's
winner fetch (``kernels/megakernel.winner_fetch``) ``stub_fetch`` is the
production kernel (held to it the same way) and ``stub_intersect`` has no
defined result (``probe_instantiation``): the stub form is left out. So it
is under two phases (``--phases 2``), where the JAX kernel's stub moves
the lanes waiting for their phase.

Time: CUDA events around one launch of K = 4 frames folded into a seeded
accumulator (frame0 = 1), a frame's ms the launch's over K, as PERF.md's
kernel table is timed. Runs on the card::

    python -m ray_tracing_extended_tpu_torch.tools.profile_mega
    python -m ray_tracing_extended_tpu_torch.tools.profile_mega \\
        --scene preset:cornell --adaptive-spp

``--scene`` takes ``preset:rtiow|cornell|mesh|wide14k`` (the presets at
their own sizes; RTIOW at 16 spp and 4 bounces; ``wide14k`` RTIOW's rule
over 14,401 spheres, past the shared-memory limit, at RTIOW's settings)
or a ``.json`` scene (its shipped settings); ``--width``, ``--height``,
``--spp`` and ``--max-bounce`` override them. ``--fast-scatter`` takes
that sampler, ``--pixels-per-lane`` and ``--phases`` refill's lane knobs
(with ``--paired`` a lane's pixels paired by the costs of a first call's
per-pixel segments), ``--tables`` forces a route. ``--device cpu`` rehearses the same steps through the plain
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
            ("dup_fetch", "dup_fetch"), ("stub_intersect", "stub_intersect"),
            ("stub_fetch", "stub_fetch"), ("stubs", "stubs"),
            ("no_cull", "no_cull"))
# the variants whose image is full's
SAME_IMAGE = ("dup_intersect", "dup_fetch", "no_cull")


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


def decompose_stubs(full, stub_intersect, stub_fetch, stubs) -> dict:
    """The stub form of the split from each variant's frame ms over the
    reps (``decompose``'s medians and ranges): ``intersect`` (full -
    stub_intersect), ``fetch`` (full - stub_fetch) and ``other`` (stubs),
    each with its share of full's median. The stub frames trace other
    paths than full's: the parts need not add up to it."""
    out = {}
    for name, ms in (("full", full), ("stub_intersect", stub_intersect),
                     ("stub_fetch", stub_fetch), ("stubs", stubs)):
        out[name] = dict(median=statistics.median(ms), min=min(ms),
                         max=max(ms))
    f = out["full"]["median"]
    for part, ms in (("intersect", f - out["stub_intersect"]["median"]),
                     ("fetch", f - out["stub_fetch"]["median"]),
                     ("other", out["stubs"]["median"])):
        out[part] = dict(ms=ms, share=ms / f)
    return out


def report(split: dict, segments: dict, frames: int,
           stub_split: dict | None = None, culls: dict | None = None) -> list[str]:
    """The JAX tool's lines from ``decompose``'s split and each variant's
    segments over a launch of ``frames`` frames: the dup form's variants
    and split; then, where given, the stub form's (``decompose_stubs``)
    and ``no_cull``'s frame with ``culls`` (``ms`` and ``share``, the
    frame time the culls save). A variant without a median (left out)
    prints as not run, with its reason from ``segments``."""
    def variant_line(name, source):
        if name not in source:
            return f"{name:14s} not run: {segments.get(name)}"
        return (f"{name:14s} {source[name]['median']:8.3f} ms "
                f"({source[name]['min']:.3f}-{source[name]['max']:.3f})  "
                f"segs={segments[name]} in {frames} frames")

    def part(name, source):
        p = source[name]
        if p.get("within_spread"):
            return f"{name} ~ within spread"
        return f"{name} ~ {p['ms']:.3f} ms ({100 * p['share']:.0f}%)"

    lines = [variant_line(n, split)
             for n in ("full", "dup_intersect", "dup_fetch")]
    lines.append(", ".join(part(n, split)
                           for n in ("intersect", "fetch", "other")))
    if stub_split is not None:
        lines += [variant_line(n, stub_split)
                  for n in ("stub_intersect", "stub_fetch", "stubs")]
        if "stubs" in stub_split:
            lines.append("stub form: " + ", ".join(
                part(n, stub_split) for n in ("intersect", "fetch", "other")))
    if culls is not None:
        lines.append(variant_line("no_cull", culls))
        lines.append(f"culls save ~ {culls['ms']:.3f} ms "
                     f"({100 * culls['share']:.0f}%)")
    return lines


def profile(scene, camera, cfg, reps: int = 7, frames: int = 4,
            tables: str | None = None, paired: bool = False,
            variants=None) -> dict:
    """Times the variants on ``scene`` at ``cfg`` (those of ``VARIANTS``
    named in ``variants``, by default all; full and the dup form always;
    without no_cull ``culls`` is None) (on the route ``tables``,
    by default the launch's own), interleaved rep by rep after one call
    each that holds the variants of ``SAME_IMAGE`` to full's bit for bit
    (raises if they differ), and under the winner fetch stub_fetch too;
    stub_intersect and stubs are left out where ``probe_instantiation``
    raises for them (the winner fetch, two phases). With ``paired`` (refill
    with more than one pixel a lane) every call pairs a lane's pixels by
    the per-pixel segments of a first full call. -> ``decompose``'s split
    with ``stub_split`` (``decompose_stubs``, None without the stubs),
    ``culls`` (no_cull's median and range, and ``ms`` / ``share``: no_cull
    - full), ``ms`` (each variant's frame ms a rep), ``segments`` (a
    launch's, or why a variant did not run), ``frames``, ``reps``,
    ``device`` and ``lines`` (``report``)."""
    from ..kernels.megakernel import (
        probe_instantiation,
        render_frames_mega,
        winner_fetch,
    )

    dev = scene.device
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    acc0 = 2.0 * torch.rand((cfg.height, cfg.width, 3), generator=gen,
                            device=dev)
    costs = None

    def call(probe):
        return render_frames_mega(scene, camera, cfg, 1, frames, accum=acc0,
                                  probe=probe, tables=tables,
                                  pair_costs=costs)

    if paired:
        costs = call(None)[2]
    winner = winner_fetch(scene)
    ref = call(None)
    segments = {"full": int(ref[1])}
    run = []
    chosen = [(n, p) for n, p in VARIANTS if variants is None
              or n in variants or n in ("full", "dup_intersect", "dup_fetch")]
    for name, probe in chosen:
        if probe in ("stub_intersect", "stubs"):
            try:
                probe_instantiation(scene, probe, cfg)
            except NotImplementedError as err:
                segments[name] = f"no result the port reproduces: {err}"
                continue
        run.append((name, probe))
        if probe is None:
            continue
        out = call(probe)
        if ((name in SAME_IMAGE or (winner and probe == "stub_fetch"))
                and not (torch.equal(out[0], ref[0])
                         and torch.equal(out[2], ref[2])
                         and int(out[1]) == int(ref[1]))):
            raise RuntimeError(f"{name} changed the image or its segments")
        segments[name] = int(out[1])

    ms = {name: [] for name, _ in run}
    for _ in range(reps):
        for name, probe in run:
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
    stub_split = culls = None

    def spread_of(name):
        return dict(median=statistics.median(ms[name]), min=min(ms[name]),
                    max=max(ms[name]))

    if all(n in ms for n in ("stub_intersect", "stub_fetch", "stubs")):
        stub_split = decompose_stubs(ms["full"], ms["stub_intersect"],
                                     ms["stub_fetch"], ms["stubs"])
    elif "stub_fetch" in ms:
        stub_split = {"stub_fetch": spread_of("stub_fetch")}
    if "no_cull" in ms:
        nc = spread_of("no_cull")
        full = split["full"]["median"]
        culls = {"no_cull": nc, "ms": nc["median"] - full,
                 "share": (nc["median"] - full) / full}
    return dict(split, stub_split=stub_split, culls=culls, ms=ms,
                segments=segments, frames=frames, reps=reps,
                device=torch.cuda.get_device_name(dev) if cuda else str(dev),
                lines=report(split, segments, frames, stub_split, culls))


def load(spec: str, device, **overrides):
    """A scene for ``--scene`` -> ``(scene, camera, config)``, with the
    config's fields in ``overrides`` (those not None) replaced."""
    from ..models import presets
    from ..models.wide_scenes import HALF_PAST_LIMIT, wide_sphere_scene
    from ..scene.json_scene import load_json_scene

    overrides = {k: v for k, v in overrides.items() if v is not None}
    if spec.endswith(".json"):
        return load_json_scene(spec, overrides=overrides, device=device)
    table = {
        "preset:rtiow": lambda: presets.rtiow_final_scene(
            max_bounce=4, spp=16, device=device),
        "preset:cornell": lambda: presets.cornell_box_scene(device=device),
        "preset:mesh": lambda: presets.mesh_scene(device=device),
        "preset:wide14k": lambda: wide_sphere_scene(
            presets, HALF_PAST_LIMIT, max_bounce=4, spp=16, device=device),
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
    p.add_argument("--fast-scatter", action="store_true")
    p.add_argument("--pixels-per-lane", type=int)
    p.add_argument("--phases", type=int)
    p.add_argument("--paired", action="store_true")
    p.add_argument("--tables", choices=("staged", "global"))
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
        adaptive_spp=True if args.adaptive_spp else None,
        fast_scatter=True if args.fast_scatter else None,
        mega_pixels_per_lane=args.pixels_per_lane, mega_phases=args.phases)
    res = profile(scene, cam, cfg, args.reps, args.frames, args.tables,
                  args.paired)
    where = res["device"] if dev.type == "cuda" else (
        "the CPU: a rehearsal, its times mean nothing")
    print(f"{args.scene} {cfg.width}x{cfg.height}, {cfg.spp} spp, "
          f"{cfg.max_bounce} bounces, "
          f"{'refill' if cfg.adaptive_spp else 'exact'}"
          f"{', fast scatter' if cfg.fast_scatter else ''}"
          f"{f', {args.pixels_per_lane} pixels a lane' if args.pixels_per_lane else ''}"
          f"{f', {args.phases} phases' if args.phases else ''}"
          f"{', paired' if args.paired else ''}"
          f"{f', {args.tables} tables' if args.tables else ''}; K={args.frames} "
          f"frames a launch, {args.reps} reps; on {where}", flush=True)
    for line in res["lines"]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
