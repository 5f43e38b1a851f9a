"""Command-line entry points of the port: ``render``, ``benchmark`` and
``compare``.

    python -m ray_tracing_extended_tpu_torch.cli render \\
        --scene scenes/chess.json --adaptive-spp --frames 16 \\
        --out chess.png --metrics chess.jsonl
    python -m ray_tracing_extended_tpu_torch.cli render --scene Chess.unity \\
        --width 1920 --height 1080 --frames 64 --checkpoint chess.npz --resume
    python -m ray_tracing_extended_tpu_torch.cli render --scene preset:rtiow \\
        --spp 16 --adaptive-spp --batch 4 --frames 8 \\
        --checkpoint rtiow.npz --checkpoint-every 4
    python -m ray_tracing_extended_tpu_torch.cli render \\
        --scene preset:three_sphere --device cpu --width 64 --height 36
    python -m ray_tracing_extended_tpu_torch.cli render --scene preset:rtiow \\
        --mesh 1x4 --frames 16 --out rtiow.png
    python -m ray_tracing_extended_tpu_torch.cli compare --scene preset:mesh \\
        --a mega --b bruteforce
    python -m ray_tracing_extended_tpu_torch.cli benchmark

Counterpart of ``ray_tracing_extended_tpu/cli.py`` with the same flags,
plus ``--device`` (default ``cuda``; ``cpu`` takes the plain PyTorch path).
Scene specs: ``preset:{three_sphere|rtiow|cornell|mesh}``, a ``.unity``
scene (``scene/unity.py``; needs PyYAML), a ``.json`` scene
(``scene/json_scene.py``; its meshes may be ``.obj`` or binary ``.fbx``),
or an ``.obj`` mesh, which renders as ``mesh_scene(obj_path=...)``
through a triangle BVH. ``--mesh SPPxTILES`` renders over SPP x TILES
cards (``parallel/sharding.py``: TILES bands of rows, SPP frame seeds a
step); with ``--device cpu`` every band runs on the CPU.

``compare`` renders one frame under two intersectors and gives the JAX
command's verdict, and names the path each side took (on the card the
kernel's instantiation: some pairs take the same one).

``benchmark`` runs the port's canonical benchmark
(``ray_tracing_extended_tpu_torch/bench.py``, the counterpart of the repo's
``bench.py``, which the JAX CLI's ``benchmark`` runs): its gates, four
secondary JSON lines, then the headline line (Mrays/s on RTIOW 1080p, 4
bounces, 16 spp) last, on ``--device`` (default ``cuda``). Without CUDA it
prints an error line and exits 1; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import numpy as np
import torch

from .utils.device import resolve_device

def _load_scene(spec: str, args):
    overrides = {}
    for k in ("width", "height", "spp", "max_bounce"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.intersector:
        overrides["intersector"] = args.intersector
    if args.hdr:
        overrides["clamp_accumulate"] = False
    if args.adaptive_spp:
        overrides["adaptive_spp"] = True
    if args.fast_scatter:
        overrides["fast_scatter"] = True

    if spec.startswith("preset:"):
        from .models import presets

        name = spec.split(":", 1)[1]
        table = {
            "three_sphere": presets.three_sphere_scene,
            "rtiow": presets.rtiow_final_scene,
            "cornell": presets.cornell_box_scene,
            "mesh": presets.mesh_scene,
        }
        fn = table.get(name)
        if fn is None:
            raise SystemExit(
                f"unknown preset {name!r}; available: {sorted(table)}"
            )
        scene, cam, cfg = fn(device=args.device)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return scene, cam, cfg.validate()
    if spec.endswith(".unity"):
        from .scene.unity import load_unity_scene

        return load_unity_scene(spec, overrides=overrides, device=args.device)
    if spec.endswith(".json"):
        from .scene.json_scene import load_json_scene

        return load_json_scene(spec, overrides=overrides, device=args.device)
    if spec.endswith(".obj"):
        from .models.presets import mesh_scene

        scene, cam, cfg = mesh_scene(obj_path=spec, device=args.device)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return scene, cam, cfg.validate()
    raise SystemExit(f"unrecognized scene spec: {spec}")


def _parse_mesh(spec: str, device: str):
    """'SPPxTILES' (e.g. '1x4', '2x4') -> a ``parallel.sharding.Mesh``:
    with a CPU ``device`` the CPU SPP x TILES times; else the first SPP x
    TILES visible cards, and an exit naming how many are visible where
    there are fewer (a card is never listed twice here)."""
    from .parallel.sharding import make_mesh

    try:
        spp_n, tiles_n = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(
            f"--mesh expects SPPxTILES (e.g. 1x4, 2x4), got {spec!r}"
        ) from None
    if spp_n < 1 or tiles_n < 1:
        raise SystemExit(f"--mesh {spec}: both counts must be at least 1")
    need = spp_n * tiles_n
    dev = torch.device(device)
    if dev.type == "cpu":
        return make_mesh([dev] * need, spp_parallel=spp_n)
    have = torch.cuda.device_count()
    if need > have:
        raise SystemExit(
            f"--mesh {spec} needs {need} CUDA devices, {have} visible "
            "(torch.cuda.device_count()); render without --mesh on one "
            "card, or split the frame on the CPU with --device cpu"
        )
    return make_mesh(range(need), spp_parallel=spp_n)


def _check_device(device: str) -> None:
    try:
        resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def cmd_render(args):
    from .progressive import render_progressive
    from .utils.metrics import MetricsLogger

    _check_device(args.device)
    mesh = _parse_mesh(args.mesh, args.device) if args.mesh else None
    scene, cam, cfg = _load_scene(args.scene, args)
    cameras = None
    if args.flythrough:
        # BASELINE config 5: a circular dolly path with defocus, scaled for
        # RTIOW-sized scenes (preset:rtiow)
        from .models.presets import flythrough_cameras

        _, cameras, fcfg = flythrough_cameras(
            args.flythrough, width=cfg.width, height=cfg.height,
            device=args.device,
        )
        if args.spp is None:
            cfg = dataclasses.replace(cfg, spp=fcfg.spp)
        if args.frames is not None and args.frames != args.flythrough:
            raise SystemExit(
                f"--frames {args.frames} conflicts with --flythrough "
                f"{args.flythrough}: the fly-through renders one frame "
                "per camera; drop --frames"
            )
        args.frames = args.flythrough
        cam = cameras[0]
    elif args.frames is None:
        args.frames = 1
    if args.reset_on_move and cameras is None:
        raise SystemExit("--reset-on-move needs --flythrough N")
    metrics = MetricsLogger(args.metrics, echo=args.verbose)
    prof = contextlib.nullcontext()
    if args.profile:
        from .utils.profiling import trace

        prof = trace(args.profile)
    try:
        with prof:
            img = render_progressive(
                scene, cam, cfg, frames=args.frames,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                metrics=metrics, cameras=cameras, mesh=mesh, batch=args.batch,
                reset_on_move=args.reset_on_move,
            )
    finally:
        metrics.close()
    if args.out:
        if args.out.endswith(".npy"):
            # raw linear radiance (HDR workflows; --hdr keeps it unclamped)
            np.save(args.out, img.cpu().numpy().astype(np.float32))
        else:
            from .utils.image import save_png

            save_png(args.out, img, tone=args.tone, exposure=args.exposure)
        print(f"wrote {args.out} ({cfg.width}x{cfg.height}, "
              f"{args.frames} frames x {cfg.spp} spp)")
    return 0


def cmd_benchmark(args):
    from .bench import run

    run(args.device)
    return 0


def cmd_compare(args):
    """Render the same frame with two intersectors and report agreement:
    the JAX command's statistics, thresholds and exit codes (0 agree, 1
    not). The verdict keys on the median pixel and the image mean (median
    per-pixel rel. < 2e-3, mean |d| < 0.1, means within 3%, no NaN): two
    paths that round one draw differently decorrelate knife-edge paths
    while both stay estimators of the same integral. The line also names
    each side's path (``kernels/megakernel.path_name``), so a pair that
    took one path shows as a trivial comparison."""
    from .kernels.megakernel import path_name
    from .render import render_frame

    _check_device(args.device)
    scene, cam, cfg = _load_scene(args.scene, args)
    imgs, paths = [], []
    for which in (args.a, args.b):
        c = dataclasses.replace(cfg, intersector=which)
        paths.append(path_name(scene, c))
        imgs.append(render_frame(scene, cam, c, args.frame).cpu().numpy())
    a, b = imgs
    d = np.abs(a - b)
    rel = (d / (1.0 + np.abs(b))).max(axis=-1)
    med = float(np.median(rel))
    mean_rel = abs(a.mean() - b.mean()) / max(b.mean(), 1e-9)
    same = " (one path: a trivial comparison)" if paths[0] == paths[1] else ""
    print(
        f"{args.a} vs {args.b}: median_rel={med:.3e} mean|d|={d.mean():.3e} "
        f"max|d|={d.max():.3e} frac(rel<3e-3)={(rel < 3e-3).mean():.4f} "
        f"means {a.mean():.5f}/{b.mean():.5f} (rel {mean_rel:.4f}) "
        f"paths {paths[0]} / {paths[1]}{same}"
    )
    ok = (
        not np.isnan(a).any()
        and not np.isnan(b).any()
        and med < 2e-3
        and d.mean() < 0.1
        and mean_rel < 0.03
    )
    print("AGREE" if ok else "DISAGREE")
    return 0 if ok else 1


def _add_scene_args(sp) -> None:
    sp.add_argument("--scene", required=True)
    sp.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu takes "
                         "the plain PyTorch path)")
    sp.add_argument("--width", type=int)
    sp.add_argument("--height", type=int)
    sp.add_argument("--spp", type=int)
    sp.add_argument("--max-bounce", dest="max_bounce", type=int)
    sp.add_argument("--intersector",
                    choices=["auto", "bruteforce", "bvh", "mega"])
    sp.add_argument(
        "--adaptive-spp", dest="adaptive_spp", action="store_true",
        help="sample refill: pixels whose tile-mates still owe samples get "
             "extra samples (>= spp each, per-pixel mean)")
    sp.add_argument(
        "--fast-scatter", dest="fast_scatter", action="store_true",
        help="2-draw unit-vector sampler (the same distribution; breaks "
             "draw-for-draw reference parity)")
    sp.add_argument("--hdr", action="store_true",
                    help="unclamped accumulation (the reference clamps)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="ray_tracing_extended_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="progressive render")
    _add_scene_args(r)
    r.add_argument(
        "--frames", type=int, default=None,
        help="frames to accumulate (default 1; implied by --flythrough N)")
    r.add_argument("--batch", type=int, default=1, metavar="K",
                   help="frames fused per kernel launch (static camera)")
    r.add_argument(
        "--flythrough", type=int, default=0, metavar="N",
        help="render an N-frame camera fly-through (circular dolly with "
             "defocus; scaled for preset:rtiow)")
    r.add_argument(
        "--reset-on-move", dest="reset_on_move", action="store_true",
        help="restart accumulation when the fly-through camera moves")
    r.add_argument(
        "--mesh", default=None, metavar="SPPxTILES",
        help="render over SPP x TILES cards: TILES bands of rows, SPP frame "
             "seeds a step (e.g. 1x4; with --device cpu every band runs on "
             "the CPU)")
    r.add_argument("--out", default=None, help=".png, or .npy for raw radiance")
    r.add_argument("--tone", default="none", choices=["none", "reinhard", "aces"])
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--resume", action="store_true")
    r.add_argument("--metrics", default=None, help="JSONL file to append to")
    r.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace to this dir")
    r.add_argument("--verbose", action="store_true")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("benchmark", help="canonical Mrays/s benchmark")
    b.add_argument("--device", default="cuda",
                   help="torch device to measure (default cuda)")
    b.set_defaults(fn=cmd_benchmark)

    c = sub.add_parser("compare", help="cross-intersector agreement check")
    _add_scene_args(c)
    c.add_argument("--a", default="mega")
    c.add_argument("--b", default="bruteforce")
    c.add_argument("--frame", type=int, default=0)
    c.set_defaults(fn=cmd_compare)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
