"""The check's control and its readings, on the card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>] [--out <file.jsonl>]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(its ``image_gap`` and ``segment_gap``: the program's readings), then
what is put in the program's place and held to the float32 reference by
the same comparison (``control_readings``):

- ``control_bf16``: the reference computed in bfloat16, the precision
  below the configuration's float32 (the running average folds in
  float32);
- ``stream_shift``: the reference in float32 over the frames one later,
  so every random stream is another: a frame's answer altered where it is
  produced;
- ``half_samples``: the reference with half of each frame's samples, the
  mean taken over the rest (its segments).

A control that comes out correct under the cell's limits would show that
the check cannot tell the program from a lower precision. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import run  # noqa: E402


def control_readings(state: dict) -> dict:
    """The numbers ``correct`` compares, for images and segment totals put
    in the program's place: the control's (``control_bf16``), and two
    faults': the random streams altered (``stream_shift``, the image) and
    half of each frame's samples left out (``half_samples``, the segments).
    A segment total in the program's place is estimated on the check's own
    (pixel, frame) pairs, so only the difference is read."""
    import numpy as np
    import torch

    from reference import Tracer

    sizes = state["sizes"]

    def tracer(dtype, spp=sizes["spp"]):
        return Tracer(state["rscene"], state["rcam"], sizes["width"],
                      sizes["height"], sizes["max_bounce"], spp,
                      state["device"], dtype, clamp=sizes["saturate"])

    pix, f0, n = state["pix_img"], state["frame0"], state["frames"]
    limits = state["limits"]
    ref32 = tracer(torch.float32)
    ref = run.reference_image(ref32, pix, f0, n)
    low = tracer(torch.bfloat16)

    def segments(t):
        return run.reference_segments(t, f0, n, np.random.default_rng(1))

    est = segments(ref32)
    out = {}
    for name, img, total in (
            ("control_bf16", run.reference_image(low, pix, f0, n),
             segments(low)),
            ("stream_shift", run.reference_image(ref32, pix, f0 + 1, n),
             None),
            ("half_samples", None,
             segments(tracer(torch.float32, max(1, sizes["spp"] // 2))))):
        r = {}
        if img is not None:
            r["image_gap"] = run.image_gap(img, ref)
        if total is not None:
            r["segment_gap"] = abs(total - est) / est
        r["correct"] = all(v <= limits[k] for k, v in r.items())
        out[name] = r
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or json.loads(
        (run.ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    for seed in args.seeds:
        result = run.run_cell(args.workload, seed, seconds, False, keep=True)
        state = result.pop("_state")
        print(result.pop("_notes"), file=sys.stderr)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v["value"] for k, v in result["checks"].items()},
                "program_correct": result["correct"],
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                **control_readings(state)}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
