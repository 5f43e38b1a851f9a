"""The import guard: what the benchmark runs loads neither JAX nor the
JAX package, and the reference loads nothing of the program either.
Top-level module names are compared whole: the port's name begins with
the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "ray_tracing_extended_tpu"}


def top_level_after(code: str) -> set:
    """The top-level names in ``sys.modules`` of a fresh interpreter after
    ``code``, with the benchmark and the checkout's root on the path."""
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}]\n"
            + code + "\nimport json; print(json.dumps(sorted({k.split('.')[0]"
            " for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_the_benchmark_runs_leaves_jax_out():
    readers = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    code = "\n".join([
        "import run, reference, trace_events, control",
        *(f"run.load_reader({n!r})" for n in readers),
        # what run_cell imports of the program, and the makers it calls
        "from ray_tracing_extended_tpu_torch import progressive, load_json_scene",
        "from ray_tracing_extended_tpu_torch.utils import checkpoint, profiling",
        "from ray_tracing_extended_tpu_torch.models import presets",
        "assert run.forbidden_modules() == [], run.forbidden_modules()",
    ])
    names = top_level_after(code)
    assert "ray_tracing_extended_tpu_torch" in names
    assert not names & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_after("import reference")
    assert not names & (JAX_SIDE | {"ray_tracing_extended_tpu_torch"})


def test_the_guard_compares_whole_names():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["ray_tracing_extended_tpu_torch_x"] = sys
        assert "ray_tracing_extended_tpu" not in run.forbidden_modules()
        sys.modules["ray_tracing_extended_tpu.kernels"] = sys
        assert run.forbidden_modules() == ["ray_tracing_extended_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
