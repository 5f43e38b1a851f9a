"""Render configuration: the manager's inspector knobs.

A copy of ``ray_tracing_extended_tpu/utils/config.py`` (pure Python, so the
port carries its own instead of importing the JAX package). Mirrors the
serialized settings at RayTracingManager.cs:12-17 plus framework knobs
(block size, accumulation clamp mode). Frozen and hashable, like the JAX
package's, so a config compares equal across the two packages field by
field. The ``mega_*`` fields are scheduler knobs of the TPU kernel; the
port reads ``mega_tile_size`` (the adaptive refill's tile, see
``adaptive_spp``) and accepts and ignores the others.

``validate()`` applies the reference's OnValidate clamps
(RayTracingManager.cs:196-203).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 320
    height: int = 180
    # [Range(0, 32)] maxBounceCount, default 4 (RayTracingManager.cs:12).
    max_bounce: int = 4
    # [Range(0, 64)] numRaysPerPixel, default 2 (RayTracingManager.cs:13).
    spp: int = 2
    # Parity mode: reference's per-frame saturate in the accumulator
    # (Accumulate.shader:50). False = HDR accumulation (extension).
    clamp_accumulate: bool = True
    # Pixels processed per device dispatch block; bounds the (rays x prims)
    # intermediate footprint. Must be a multiple of 256 for lane alignment.
    block_size: int = 32768
    # Intersector selection: "auto" picks BVH when present else brute force.
    intersector: str = "auto"
    # Adaptive sample refill (megakernel only): lanes that finish their
    # ``spp`` samples keep tracing EXTRA samples (continuing their pixel's
    # RNG stream) while any lane in their tile is still below target; each
    # pixel's output is the mean of its actually-completed samples
    # (>= spp). The tile is the TPU kernel's: 128 x 128 pixels, 64 x 64 for
    # a scene past the JAX package's one-hot fetch limit, or
    # ``mega_tile_size`` (kernels/megakernel.py refill_tile_size), on the
    # card and in the plain version alike. Off by default: every pixel then
    # gets EXACTLY spp samples (reference parity, RayTracing.shader:374),
    # and output is independent of tile layout / device count; with refill
    # the extra-sample count depends on tile companions, so images are
    # deterministic only for a fixed layout. Consistent, MC-level agreement
    # with the exact-spp mean: the refill WINDOW is set by the tile's
    # slowest lanes (not by a lane's own sample values), but the number of
    # refill samples a lane completes inside that window does correlate
    # with its own path lengths, and refills still in flight when the
    # static slot bound is exhausted are dropped - a stopping-time effect
    # bounded by ~one partial sample over >= spp completed ones.
    # MEASURED on the card (tools/adaptive_bias.py, paired 32-frame image
    # means, shared RNG streams; NVIDIA H100 80GB HBM3, 700.00 W): RTIOW
    # 480x270 spp16 rel bias +0.446% +- 0.010% (95% CI, t=84.3); Cornell
    # 256x256 depth-8 +0.074% +- 0.083% (consistent with 0). Grouped by
    # warps (32 pixels) before, the card measured +0.710% +- 0.006% and
    # +0.142% +- 0.056%. The JAX package measured on a TPU v5e +0.198% +-
    # 0.013% and -0.048% +- 0.084% (its utils/config.py). Use the default
    # exact-spp mode where strict estimator neutrality matters.
    adaptive_spp: bool = False
    # Fast scatter sampler (megakernel only): Marsaglia-style uniform unit
    # vector (2 PCG draws, sqrt+sin+cos) instead of the reference's three
    # Box-Muller Gaussians (6 draws, ~9 transcendentals;
    # RayTracing.shader:216-223). The DISTRIBUTION is identical (uniform
    # sphere -> same cosine-weighted scatter), so renders converge to the
    # same image; individual samples differ because the draw sequence
    # changes. Off by default for draw-for-draw reference parity.
    fast_scatter: bool = False
    # Megakernel scheduler tuning (production surface for what the
    # RTX_MEGA_TS / RTX_MEGA_PPL / RTX_MEGA_PHASES env vars expose for
    # perf experiments). None = measured-optimal auto defaults
    # (kernels/megakernel.py tile_size / pixels_per_lane / n_phases).
    # These are jit cache keys like every other config field, so they
    # compose correctly with the jitted public entry points - unlike an
    # env-var change, which a warm jit cache ignores. The env vars, when
    # set, still win (dev override for A/B tools).
    mega_tile_size: int | None = None  # TS*TS must be a multiple of 128
    mega_pixels_per_lane: int | None = None  # 1, 2, 4 or 8
    mega_phases: int | None = None  # 1 = mixed slots, 2 = coherence split
    # per-row sub drain on tri scenes with >1 super-cluster: output
    # bit-identical either way; wall clock is size-dependent (bunny
    # 2188 subs +13%, Chess 186 subs -23%), so None = auto (on at
    # >= 1024 subs, megakernel.ROWDRAIN_MIN_SUBS). True/False force.
    mega_rowdrain: bool | None = None

    def validate(self) -> "RenderConfig":
        """Clamp like OnValidate (RayTracingManager.cs:196-203) and check
        framework invariants."""
        cfg = dataclasses.replace(
            self,
            max_bounce=max(0, self.max_bounce),
            spp=max(1, self.spp),
        )
        if cfg.width <= 0 or cfg.height <= 0:
            raise ValueError("image dimensions must be positive")
        if cfg.block_size % 256 != 0:
            raise ValueError("block_size must be a multiple of 256")
        ts = cfg.mega_tile_size
        if ts is not None and (ts <= 0 or (ts * ts) % 128 != 0):
            raise ValueError(
                "mega_tile_size must be a positive tile size with TS*TS "
                f"a multiple of 128 (e.g. 32/64/96/128), got {ts}"
            )
        if cfg.mega_pixels_per_lane not in (None, 1, 2, 4, 8):
            raise ValueError(
                "mega_pixels_per_lane must be 1, 2, 4 or 8, got "
                f"{cfg.mega_pixels_per_lane}"
            )
        if cfg.mega_phases not in (None, 1, 2):
            raise ValueError(
                f"mega_phases must be 1 or 2, got {cfg.mega_phases}"
            )
        if cfg.mega_rowdrain not in (None, True, False):
            raise ValueError(
                f"mega_rowdrain must be a bool, got {cfg.mega_rowdrain}"
            )
        return cfg

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
