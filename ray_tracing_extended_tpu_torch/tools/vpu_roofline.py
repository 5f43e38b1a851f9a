"""The card's FP32 mul+max issue rate: the denominator of the path-trace
kernel's operation bound (PERF.md), measured instead of taken from the
data sheet.

Counterpart of ``tools/vpu_roofline.py`` (the JAX tool's Pallas kernel,
ported to ``csrc/vpu_roofline.cu``): for each of ``grid * 32 * 128``
elements, eight independent f32 accumulators run ``n_steps`` steps of
``max(a * 0.9999, 0.125)``, then are summed in order. Each step is two
operations, counted separately. The defaults are the JAX tool's constants.

    python -m ray_tracing_extended_tpu_torch.tools.vpu_roofline

prints one JSON line with the JAX tool's keys (``vpu_tflops``,
``wall_ms``, ``t1_ms``, ``el_ops``, ``device``). ``wall_ms`` is the median
of CUDA-event times of single launches after a warm-up; ``t1_ms`` one
launch timed on the host clock to its synchronise. (The JAX tool took the
difference of k pipelined dispatches to cancel the round trip of a remote
TPU connection; CUDA events time the device directly.) Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import time

import numpy as np
import torch

from ..kernels.build import CudaLibrary

N_STEPS = 16384
N_ACC = 8
GRID = 256
SHAPE = (32, 128)


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rtx_vpu_chain.argtypes = [vp, ci, ci, vp]
    lib.rtx_vpu_chain.restype = ci


LIBRARY = CudaLibrary("vpu_roofline.cu", "vpu_roofline", _bind)
# launches of the kernel made through ``vpu_chain``
LAUNCHES = {"vpu_roofline": 0}


def el_ops(n_steps: int = N_STEPS, grid: int = GRID) -> int:
    """The multiplies and maxes of one call (the sum at the end is not
    counted, as in the JAX tool)."""
    return grid * n_steps * N_ACC * 2 * SHAPE[0] * SHAPE[1]


def vpu_chain_plain(n_steps: int = N_STEPS, grid: int = GRID,
                    device="cpu") -> torch.Tensor:
    """The plain PyTorch version: the (grid * 32, 128) f32 output."""
    dev = torch.device(device)

    def f32(x):
        return torch.tensor(np.float32(x), device=dev)

    lane = torch.arange(SHAPE[1], dtype=torch.float32, device=dev)
    base = lane.expand(grid * SHAPE[0], SHAPE[1])
    accs = [base * f32(0.001 * (k + 1)) + f32(1.0) for k in range(N_ACC)]
    m, c = f32(0.9999), f32(0.125)
    for _ in range(n_steps):
        accs = [torch.maximum(a * m, c) for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def vpu_chain(n_steps: int = N_STEPS, grid: int = GRID,
              device="cuda") -> torch.Tensor:
    """The probe's output on ``device``: on a CUDA device one launch of the
    kernel (counted in ``LAUNCHES``), on the CPU the plain version."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return vpu_chain_plain(n_steps, grid)
    if dev.type != "cuda":
        raise ValueError(f"no vpu_chain for device {dev}")
    out = torch.empty((grid * SHAPE[0], SHAPE[1]), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib.rtx_vpu_chain(
            out.data_ptr(), out.numel(), n_steps,
            torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(rc, "vpu_roofline")
    LAUNCHES["vpu_roofline"] += 1
    return out


def event_ms(fn, reps: int = 7) -> list[float]:
    """CUDA-event milliseconds of ``reps`` single calls of ``fn`` after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def measure(n_steps: int = N_STEPS, grid: int = GRID, reps: int = 7) -> dict:
    """Time the kernel on the card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the vpu probe measures a CUDA card; none is available")
    LIBRARY.build()
    ms = statistics.median(event_ms(lambda: vpu_chain(n_steps, grid), reps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vpu_chain(n_steps, grid)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    ops = el_ops(n_steps, grid)
    return {
        "vpu_tflops": ops / (ms * 1e-3) / 1e12,
        "wall_ms": ms,
        "t1_ms": t1 * 1e3,
        "el_ops": ops,
        "device": torch.cuda.get_device_name(0),
    }


if __name__ == "__main__":
    print(json.dumps(measure()))
