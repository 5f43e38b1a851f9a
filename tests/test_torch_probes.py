"""The port's two roofline probes on the CPU, in their plain form, against
the JAX tools' Pallas kernels run in interpret mode.

``tools/`` is no package: each JAX tool is loaded from its file, and its
sizes (``N_STEPS`` and ``GRID``, ``STEPS`` and ``GRID``) are shrunk on the
loaded module object. The port's functions take the sizes as arguments.

Tolerances. The vpu chain is multiplies, maxes and adds with nothing to
fuse: bit for bit. The pair block: XLA's CPU backend contracts the
multiply-adds of ``b`` and ``cc`` into FMAs, which the port (like its CUDA
kernel, built with -fmad=false) does not, so the same entries hit or miss,
and a variant with the wide encode agrees bit for bit on at least 99.5% of
entries (measured: 99.8-100%), the rest differing only below the encode's
2^-12 relative granularity (an ulp of ``tq`` that crosses a masked
2048-ulp step). The kernel is held to the plain version bit for bit on
the card (``tests/test_torch_cuda.py``). The
variants without the encode keep those ulps: noenc and twophase within
1e-4 relative, nosqrt, whose ``-b - (b^2 - cc) / 2`` cancels to values
near 0, within 1e-4 absolute.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tracing_extended_tpu_torch.tools import pairblock_roofline as tpb
from ray_tracing_extended_tpu_torch.tools import vpu_roofline as tvpu

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


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


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_vpu_chain_matches_jax_kernel_interpret(monkeypatch):
    jv = _load("vpu_roofline")
    monkeypatch.setattr(jv, "N_STEPS", 5)
    monkeypatch.setattr(jv, "GRID", 2)
    # the specs of the JAX tool's measure (vpu_roofline.py:52-59)
    out = pl.pallas_call(
        jv._kernel,
        grid=(jv.GRID,),
        out_specs=pl.BlockSpec(jv.SHAPE, lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((jv.GRID * jv.SHAPE[0], jv.SHAPE[1]),
                                       jnp.float32),
        interpret=True,
    )()
    ours = tvpu.vpu_chain(5, 2, device="cpu")
    assert ours.shape == (64, 128) and ours.dtype == torch.float32
    assert np.array_equal(np.asarray(out).view(np.int32),
                          ours.numpy().view(np.int32))
    assert tvpu.LAUNCHES["vpu_roofline"] == 0  # the CPU never launches
    assert tvpu.el_ops() == 256 * 16384 * 8 * 2 * 32 * 128


def _jax_pairblock(jpb, variant, rays, cols):
    """The JAX tool's pallas_call with the specs of its measure
    (pairblock_roofline.py:276-304), in interpret mode, on the TPU layout
    of the table that the variant reads."""
    if variant.startswith("multisub"):
        fuse = int(variant[-1])
        cols = cols.reshape(jpb.NCL // fuse, fuse * jpb.SUB, 8)
    elif variant == "multirow":
        cols = np.repeat(
            cols[..., [0, 1, 2, 4]].reshape(jpb.NCL * jpb.SUB * 4, 1),
            jpb.LANES, axis=1,
        ).astype(np.float32)
    fn = pl.pallas_call(
        jpb._make_kernel(variant),
        grid=(jpb.GRID,),
        in_specs=[
            pl.BlockSpec(rays.shape, lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(cols.shape, lambda i, _nd=cols.ndim: (0,) * _nd,
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((jpb.RS, jpb.LANES), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((jpb.GRID * jpb.RS, jpb.LANES),
                                       jnp.float32),
        scratch_shapes=[pltpu.VMEM((jpb.RS, jpb.LANES), jnp.float32)],
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(rays), jnp.asarray(cols)))


@pytest.mark.parametrize("variant", tpb.VARIANTS)
def test_pairblock_matches_jax_kernel_interpret(monkeypatch, variant):
    jpb = _load("pairblock_roofline")
    monkeypatch.setattr(jpb, "STEPS", 2)
    monkeypatch.setattr(jpb, "GRID", 1)
    rays, cols = tpb.make_inputs()
    a = _jax_pairblock(jpb, variant, rays, cols)
    b = tpb.pairblock(torch.from_numpy(rays), torch.from_numpy(cols), variant,
                      steps=2, grid=1).numpy()
    assert a.shape == b.shape == (8, 128)
    hit = np.isfinite(a)
    assert np.array_equal(hit, np.isfinite(b)) and hit.mean() > 0.25
    exact = a.view(np.int32) == b.view(np.int32)
    diff, mag = np.abs(a[hit] - b[hit]), np.abs(a[hit])
    if variant in ("noenc", "twophase"):
        assert (diff <= 1e-4 * mag).all(), (diff / mag).max()
    elif variant == "nosqrt":
        assert (diff <= 1e-4).all(), diff.max()
    else:
        assert exact.mean() >= 0.995, exact.mean()
        assert (diff < 2.0 ** -12 * mag).all(), (diff / mag).max()
    assert tpb.LAUNCHES[variant] == 0


# The root only where disc >= 0 (the kernel's and the plain version's
# form) against the unguarded numpy float32 formula, bit for bit: where
# disc < 0 the unguarded root is NaN, the hit test fails and both give
# +inf; -0.0 >= 0 holds, so -0.0 takes the same root.
ROOT_VARIANTS = ("full", "noenc", "nomin", "multisub2", "multisub4",
                 "multirow")
_F32 = np.float32


def _unguarded(b, disc, idx, variant):
    with np.errstate(invalid="ignore"):
        tq = -b - np.sqrt(disc)
    assert tq.dtype == np.float32
    if variant == "noenc":
        return np.where(tq >= 0, tq, _F32(np.inf))
    enc = ((tq.view(np.int32) & ~2047) | idx).view(np.float32)
    return np.where(tq >= 0, enc, _F32(np.inf))


def _same_bits(ours, ref):
    ours = ours.numpy()
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours.view(np.int32), ref.view(np.int32)), (ours, ref)


# (b, disc): disc +0.0 and -0.0 with b of either sign and zero, denormal
# discs of either sign, disc < 0 with b < 0, a hit, a root behind the origin
EDGE_B_DISC = [
    (-3.0, 0.0), (-3.0, -0.0), (0.0, 0.0), (0.0, -0.0), (-0.0, 0.0),
    (-0.0, -0.0), (2.0, -0.0), (0.0, 2.0 ** -149), (-1e-20, 2.0 ** -140),
    (-0.0, 2.0 ** -126), (1e-30, 2.0 ** -149), (-5.0, -(2.0 ** -149)),
    (-5.0, -3.0), (-1e-3, -1e-30), (-5.0, 1.0), (5.0, 1.0), (0.3, 1.5),
]


@pytest.mark.parametrize("variant", ROOT_VARIANTS)
def test_pairblock_guarded_root_matches_unguarded_on_edges(variant):
    b, disc = (np.array(x, np.float32) for x in zip(*EDGE_B_DISC))
    idx = np.arange(len(b), dtype=np.int32) * 37
    ours = tpb.root_value(torch.from_numpy(b), torch.from_numpy(disc),
                          torch.from_numpy(idx), variant)
    ref = _unguarded(b, disc, idx, variant)
    _same_bits(ours, ref)
    assert np.isfinite(ref).sum() >= 4  # hits among the cases


def test_pairblock_guarded_root_matches_unguarded_sweep():
    """A seeded sweep of b and disc over magnitudes 2^-149 to 2^60, both
    signs, with the exact zeros mixed in."""
    rng = np.random.default_rng(11)
    n = 200_000
    mant = rng.uniform(1.0, 2.0, size=(2, n))
    expo = rng.integers(-149, 61, size=(2, n))
    sign = rng.choice([-1.0, 1.0], size=(2, n))
    b, disc = (sign * np.ldexp(mant, expo)).astype(np.float32)
    disc[::97] = 0.0
    disc[1::97] = -0.0
    b[2::89] = -0.0
    idx = rng.integers(0, 512, size=n, dtype=np.int32)
    for variant in ("full", "noenc"):
        ours = tpb.root_value(torch.from_numpy(b), torch.from_numpy(disc),
                              torch.from_numpy(idx), variant)
        _same_bits(ours, _unguarded(b, disc, idx, variant))


# (centre, r^2, origin, direction, what disc is there): the pair test from
# the ray and the sphere
EDGE_GEOMETRY = {
    "tangent": ((0, 0, 0), 1.0, (1, 0, -5), (0, 0, 1), "zero"),
    "denormal_disc": ((0, 0, 0), 2.0 ** -127, (0, 2.0 ** -64, 0), (1, 0, 0),
                      "denormal"),
    "miss_in_front": ((0, 0, 0), 1.0, (2, 0, -5), (0, 0, 1), "negative"),
    "origin_inside": ((0, 0, 0), 1.0, (0.1, 0.2, 0.3), (0.6, 0, 0.8),
                      "positive"),
    "hit": ((0, 0, 0), 1.0, (0, 0, -5), (0, 0, 1), "positive"),
    "behind": ((0, 0, 0), 1.0, (0, 0, 5), (0, 0, 1), "positive"),
}


@pytest.mark.parametrize("case", sorted(EDGE_GEOMETRY))
def test_pairblock_guarded_pair_test_matches_unguarded(case):
    centre, r2, o, d, kind = EDGE_GEOMETRY[case]
    c = [np.array([x], np.float32) for x in centre]
    o = [np.array([x], np.float32) for x in o]
    d = [np.array([x], np.float32) for x in d]
    r2 = np.array([r2], np.float32)
    oc = [o[k] - c[k] for k in range(3)]
    b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r2
    disc = b * b - cc
    assert {"zero": disc == 0, "negative": disc < 0,
            "positive": disc >= 2.0 ** -126,
            "denormal": (disc > 0) & (disc < 2.0 ** -126)}[kind].all()
    assert case != "miss_in_front" or (b < 0).all()
    assert case != "origin_inside" or (cc < 0).all()
    idx = np.array([(5 << 5) | 7], np.int32)
    t = torch.from_numpy
    for variant in ROOT_VARIANTS:
        ours = tpb.pair_test(*map(t, c), t(r2), t(idx), tuple(map(t, o)),
                             tuple(map(t, d)), variant)
        _same_bits(ours, _unguarded(b, disc, idx, variant))


def test_pairblock_inputs_and_counts():
    """The JAX tool's rng(7) sequence, and its pair count."""
    rays, cols = tpb.make_inputs()
    assert rays.shape == (48, 128) and cols.shape == (16, 32, 8)
    rng = np.random.default_rng(7)
    first = rng.normal(size=(48, 128)).astype(np.float32)
    np.testing.assert_array_equal(rays[3:24], first[3:24])
    np.testing.assert_allclose(np.linalg.norm(rays[24:].reshape(3, 8, 128),
                                              axis=0), 1.0, rtol=1e-6)
    assert (cols[..., 4] == 0.25).all() and (cols[..., 3] == 0).all()
    assert tpb.pairs() == 1_073_741_824
    # every program computes the same rows
    out = tpb.pairblock_plain(torch.from_numpy(rays), torch.from_numpy(cols),
                              "full", steps=1, grid=3)
    assert torch.equal(out[:8], out[8:16]) and torch.equal(out[:8], out[16:])
    with pytest.raises(ValueError):
        tpb.pairblock(torch.from_numpy(rays), torch.from_numpy(cols), "nope")


def test_probes_refuse_to_measure_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvpu.measure(n_steps=1, grid=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpb.measure("full", steps=1, grid=1)
