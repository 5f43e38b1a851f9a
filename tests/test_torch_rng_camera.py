"""The port's RNG, camera and vector math against the JAX package.

Inputs are made with numpy from a fixed seed and go through both packages.
The integer PCG recurrence and the u32 -> f32 conversion are exact across
frameworks, so they are held bit for bit. Everything after a transcendental
(cos, sin, log, sqrt, rsqrt) may differ by about an ulp between XLA and
PyTorch, so those are held to stated absolute tolerances.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import reference_tracer as ref
from ray_tracing_extended_tpu.ops import camera as jcam
from ray_tracing_extended_tpu.ops import rng as jrng
from ray_tracing_extended_tpu.ops import vecmath as jvm
from ray_tracing_extended_tpu_torch.interop import camera_from_arrays
from ray_tracing_extended_tpu_torch.ops import camera as tcam
from ray_tracing_extended_tpu_torch.ops import rng as trng
from ray_tracing_extended_tpu_torch.ops import vecmath as tvm

# An ulp of cos/log/rsqrt on values up to ~5 (Box-Muller normals).
DRAW_ATOL = 1e-6
# Focus points and rays: world coordinates of magnitude ~15 (RTIOW camera).
CAMERA_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over (each small op then waits on its
    parallel region)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    """A (pixel, frame) grid including the u32 wrap region."""
    pix = np.array([0, 1, 2, 1919, 2073599, 12345, 0x7FFFFFFF, 0xFFFFFFFF],
                   np.uint64)
    frames = np.array([0, 1, 5, 719, 65535, 0xFFFFFFFF], np.uint64)
    return np.repeat(pix, frames.size), np.tile(frames, pix.size)


def _t(state_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(state_u32.astype(np.int64))


def _states(n=4096, seed=0):
    return np.random.RandomState(seed).randint(
        0, 2**32, size=n, dtype=np.uint64
    ).astype(np.uint32)


def test_seed_bit_exact_over_pixel_frame_grid():
    pix, frames = _grid()
    got = np.array([int(trng.seed(torch.tensor([int(p)]), int(f))[0])
                    for p, f in zip(pix, frames)])
    want = np.asarray(jrng.seed(jnp.asarray(pix.astype(np.uint32)),
                                jnp.asarray(frames.astype(np.uint32))))
    scalar = (pix + frames * 719393) & 0xFFFFFFFF
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, scalar.astype(np.int64))


@pytest.mark.parametrize("steps", [1, 64])
def test_next_random_bit_exact(steps):
    pix, frames = _grid()
    s = ((pix + frames * 719393) & 0xFFFFFFFF).astype(np.uint32)
    t_state, j_state = _t(s), jnp.asarray(s)
    scalars = [int(v) for v in s]
    for _ in range(steps):
        t_state, t_out = trng.next_random(t_state)
        j_state, j_out = jrng.next_random(j_state)
        stepped = [ref.next_random(v) for v in scalars]
        scalars = [st for st, _ in stepped]
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_out.numpy(), [o for _, o in stepped])
    np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
    np.testing.assert_array_equal(t_state.numpy(), scalars)


def test_random_value_bit_exact():
    s = _states()
    t_state, j_state = _t(s), jnp.asarray(s)
    for _ in range(8):
        t_state, tv = trng.random_value(t_state)
        j_state, jv = jrng.random_value(j_state)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.dtype == torch.float32


@pytest.mark.parametrize(
    "name", ["random_value_normal", "random_direction", "random_point_in_circle"]
)
def test_vector_draws_match(name):
    s = _states(seed=1)
    t_state, tv = getattr(trng, name)(_t(s))
    j_state, jv = getattr(jrng, name)(jnp.asarray(s))
    # the draw count is exact; the values agree to an ulp-level tolerance
    np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=DRAW_ATOL)


def test_vecmath_matches():
    rs = np.random.RandomState(2)
    a = rs.randn(512, 3).astype(np.float32)
    b = rs.randn(512, 3).astype(np.float32)
    t = rs.rand(512, 1).astype(np.float32)
    ta, tb, tt = map(torch.from_numpy, (a, b, t))
    pairs = [
        (tvm.dot(ta, tb), jvm.dot(a, b)),
        (tvm.normalize(ta), jvm.normalize(a)),
        (tvm.reflect(ta, tvm.normalize(tb)), jvm.reflect(a, jvm.normalize(b))),
        (tvm.lerp(ta, tb, tt), jvm.lerp(a, b, t)),
        (tvm.cross(ta, tb), jvm.cross(a, b)),
        (tvm.smoothstep(-0.5, 0.5, ta), jvm.smoothstep(-0.5, 0.5, a)),
        (tvm.saturate(ta), jvm.saturate(a)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


CAMERAS = [
    dict(position=(13.0, 2.0, 3.0), target=(0.0, 0.0, 0.0), fov_y_deg=20.0,
         focus_distance=10.0, defocus_strength=20.0, diverge_strength=1.0),
    dict(position=(0.0, 0.25, -2.6), target=(0.0, 0.0, 0.0), fov_y_deg=45.0,
         focus_distance=2.6, defocus_strength=0.0, diverge_strength=0.5),
]


@pytest.mark.parametrize("kw", CAMERAS)
def test_look_at_identical(kw):
    j = jcam.look_at(**kw)
    for t in (tcam.look_at(**kw, device="cpu"),
              camera_from_arrays(j, device="cpu")):
        for name in ("position", "rotation", "fov_y_deg", "focus_distance",
                     "defocus_strength", "diverge_strength"):
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), np.asarray(getattr(j, name))
            )


@pytest.mark.parametrize("kw", CAMERAS)
def test_focus_points_and_rays_match(kw):
    j = jcam.look_at(**kw)
    t = camera_from_arrays(j, device="cpu")
    width, height = 96, 54
    pix = np.random.RandomState(3).randint(0, width * height, 1024)
    x, y = pix % width, pix // width
    j_fp = jcam.focus_points(j, jnp.asarray(x), jnp.asarray(y), width, height)
    t_fp = tcam.focus_points(t, torch.from_numpy(x), torch.from_numpy(y),
                             width, height)
    np.testing.assert_allclose(t_fp.numpy(), np.asarray(j_fp), rtol=0,
                               atol=CAMERA_ATOL)

    s = _states(1024, seed=4)
    js, jo, jd = jcam.generate_rays(jnp.asarray(s), j, j_fp, width)
    ts, to, td = tcam.generate_rays(_t(s), t, t_fp, width)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=CAMERA_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=CAMERA_ATOL)
