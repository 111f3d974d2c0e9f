"""Double-single exact math: corrected division and correctly-rounded pow.

On the CPU backend, plain XLA div/pow ARE glibc (the reference's math), so:
- `corrected_div` must be bit-identical to plain division everywhere;
- `ds_pow` must be bit-identical except on inputs glibc misrounds (its powf
  has ~0.82 ulp max error; ds_pow returns the correctly-rounded value), and
  after u8 export quantization the two must agree on the FULL u8 grid —
  which is what golden parity needs on the GPU.
"""

import jax
import numpy as np
import pytest

from kanter_core_tpu.ops.exact_math import corrected_div, ds_pow

GRID = np.arange(256, dtype=np.float32) / np.float32(255.0)
A = np.tile(GRID[:, None], (1, 256))
B = np.tile(GRID[None, :], (256, 1))


def _f32_mismatches(got, ref):
    bad = (got.view(np.uint32) != ref.view(np.uint32)) & ~(
        np.isnan(got) & np.isnan(ref)
    )
    return int(bad.sum())


def test_corrected_div_bit_identical_to_hardware_div():
    with np.errstate(all="ignore"):
        ref = (A / B).astype(np.float32)
    got = np.asarray(jax.jit(corrected_div)(A, B))
    assert _f32_mismatches(got, ref) == 0

    rng = np.random.default_rng(7)
    aa = (rng.standard_normal(200_000) * np.exp2(rng.integers(-30, 30, 200_000))).astype(np.float32)
    bb = (rng.standard_normal(200_000) * np.exp2(rng.integers(-30, 30, 200_000))).astype(np.float32)
    with np.errstate(all="ignore"):
        ref = (aa / bb).astype(np.float32)
    got = np.asarray(jax.jit(corrected_div)(aa, bb))
    assert _f32_mismatches(got, ref) == 0


def test_ds_pow_u8_grid():
    ref = np.asarray(jax.jit(lambda x, y: x**y)(A, B))  # CPU == glibc powf
    got = np.asarray(jax.jit(ds_pow)(A, B))
    # f32 level: only glibc's own misrounds may differ (48 with glibc 2.3x)
    assert _f32_mismatches(got, ref) < 200
    # u8 export level: byte-identical across the whole input domain
    def to_u8(v):
        c = np.clip(v, 0.0, 1.0) * np.float32(255.0)
        c = np.where(np.isnan(c), np.float32(255.0), np.minimum(c, np.float32(255.0)))
        return c.astype(np.uint8)

    assert int((to_u8(got) != to_u8(ref)).sum()) == 0


@pytest.mark.parametrize(
    "a,b",
    [
        (np.nan, 0.0),      # pow(NaN, 0) = 1
        (1.0, np.nan),      # pow(1, NaN) = 1
        (0.0, -2.0),        # 0^-2 = inf
        (0.0, 3.0),         # 0^3 = 0
        (-2.0, 3.0),        # (-2)^3 = -8
        (-2.0, 2.0),        # (-2)^2 = 4
        (-2.0, 0.5),        # NaN (non-integer exponent)
        (-np.inf, 3.0),     # -inf
        (-np.inf, 2.0),     # +inf
        (np.inf, -1.0),     # 0
        (np.inf, 2.0),      # inf
        (2.0, -3.0),        # 0.125
        (0.5, -2.0),        # 4.0
        (-1.0, np.inf),     # pow(-1, inf): glibc → 1
        (-0.0, 3.0),        # pow(-0, odd) = -0
        (-0.0, 2.0),        # pow(-0, even) = +0
        (-0.0, -3.0),       # pow(-0, -odd) = -inf
        (-np.inf, -3.0),    # pow(-inf, -odd) = -0
    ],
)
def test_ds_pow_special_cases(a, b):
    ref = np.asarray(
        jax.jit(lambda x, y: x**y)(np.float32(a), np.float32(b))
    )
    got = np.asarray(jax.jit(ds_pow)(np.float32(a), np.float32(b)))
    if np.isnan(ref):
        assert np.isnan(got), (a, b, got, ref)
    else:
        assert got.view(np.uint32) == ref.view(np.uint32), (a, b, got, ref)


def test_mix_divide_and_pow_goldens_still_exact():
    """The goldens already cover this end-to-end; this pins the kernels."""
    from kanter_core_tpu.ops.mix import _gray_kernel
    from kanter_core_tpu.node import MixType

    with np.errstate(all="ignore"):
        ref_div = (A / B).astype(np.float32)
    got_div = np.asarray(_gray_kernel(MixType.DIVIDE)(A, B))
    assert _f32_mismatches(got_div, ref_div) == 0

    ref_pow = np.asarray(jax.jit(lambda x, y: x**y)(A, B))
    got_pow = np.asarray(_gray_kernel(MixType.POW)(A, B))
    assert _f32_mismatches(got_pow, ref_pow) == 0  # CPU path = plain pow


def test_corrected_div_nonfinite_and_huge_divisors():
    """The Dekker refinement must fall back to the plain quotient where its
    intermediates go non-finite: b = ±inf (split(inf) → NaN; the right
    answer is exactly 0) and |q|/|b| past the Veltkamp-splittable ~8.3e34
    (4097·x overflows). Regression: these returned NaN on every backend."""
    import jax.numpy as jnp

    f = jnp.float32
    inf = np.float32(np.inf)
    assert np.float32(corrected_div(f(2.0), f(inf))) == 0.0
    got = np.float32(corrected_div(f(2.0), f(-inf)))
    assert got == 0.0 and np.signbit(got)  # IEEE: 2/-inf = -0.0
    assert np.float32(corrected_div(f(3e38), f(3000.0))) == np.float32(1e35)
    with np.errstate(over="ignore"):
        want = np.float32(1e38) / np.float32(1e-3)  # overflows to inf in f32
    assert np.float32(corrected_div(f(1e38), f(1e-3))) == want
    # the documented inf/NaN encodings stay
    assert np.isposinf(np.float32(corrected_div(f(1.0), f(0.0))))
    assert np.isnan(np.float32(corrected_div(f(0.0), f(0.0))))


def test_nc_mul_propagates_nonfinite_like_two_rounding():
    """nc_mul's decoy error term must not poison the product: inf/NaN
    operands (or magnitudes past the splittable bound) made
    p + (NaN − NaN) = NaN where Rust/numpy two-rounding gives ±inf.
    Reachable: Blur/resample of a plane containing a divide-by-zero inf."""
    from kanter_core_tpu.ops.exact_math import nc_mul
    import jax.numpy as jnp

    f = jnp.float32
    inf = np.float32(np.inf)
    assert np.isneginf(np.float32(nc_mul(f(-inf), f(0.5))))
    assert np.isposinf(np.float32(nc_mul(f(inf), f(2.0))))
    assert np.isnan(np.float32(nc_mul(f(np.nan), f(0.5))))
    assert np.float32(nc_mul(f(1e35), f(2.0))) == np.float32(2e35)
    assert np.isposinf(np.float32(nc_mul(f(3e38), f(3e38))))  # overflow → inf
    # ... while staying exactly fl(x·y) on the normal range
    rng = np.random.default_rng(3)
    a = rng.random(4096, dtype=np.float32)
    b = rng.random(4096, dtype=np.float32)
    got = np.asarray(jax.jit(nc_mul)(a, b))
    assert _f32_mismatches(got, a * b) == 0


def test_compile_graph_cache_distinguishes_none_and_empty_targets():
    """targets=None (default outputs) and targets=[] (a program computing
    nothing) must not share a cache entry."""
    from kanter_core_tpu import Node, NodeGraph, NodeType, SlotId
    from kanter_core_tpu.compiler import compile_graph

    g = NodeGraph()
    val = g.add_node(Node(NodeType.Value(0.5)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(val, out, SlotId(0), SlotId(0))

    empty = compile_graph(g, targets=[])
    assert empty() == {}
    full = compile_graph(g)  # must NOT hit the empty-targets entry
    assert (out, SlotId(0)) in full()


def test_constant_divisor_division_is_true_ieee_on_cpu():
    """XLA:CPU's algebraic simplifier rewrites division by a compile-time
    CONSTANT into multiplication by the reciprocal (~1 ulp off on ~39% of
    inputs for /3, measured 6422/16384 vs true division) — diverging from
    the reference's plain Rust `/` (`slot_image.rs:247-250`). Every
    constant divisor in a traced consumer must hide behind an
    optimization_barrier / `_const_guard` (or route through corrected_div
    off-CPU). Pins the rgba→gray /3 in BOTH its homes: the eager
    `SlotImage.as_type` converter and the fused `compiler._as_type`
    (shared by tiled/bucketed)."""
    import jax.numpy as jnp

    from kanter_core_tpu.compiler import ImgVal, _as_type
    from kanter_core_tpu.slot_image import SlotImage
    from kanter_core_tpu.transient_buffer import plane_from_host

    rng = np.random.default_rng(77)
    r, g, b = (
        rng.integers(0, 256, (128, 128)).astype(np.float32) / np.float32(255.0)
        for _ in range(3)
    )
    ref = ((r + g) + b) / np.float32(3.0)  # numpy = hardware IEEE true div

    # eager path (slot_image._jitted_converters rgb_mean)
    img = SlotImage([plane_from_host(p) for p in (r, g, b, np.ones_like(r))])
    got = np.asarray(img.as_type(rgba=False).planes[0].data())
    assert _f32_mismatches(got, ref) == 0

    # fused/tiled/bucketed path (compiler._as_type)
    @jax.jit
    def fused(r, g, b, a):
        return _as_type(ImgVal([r, g, b, a]), rgba=False).planes[0]

    got = np.asarray(fused(r, g, b, jnp.ones_like(r)))
    assert _f32_mismatches(got, ref) == 0

    # the srgb export's constant divisors (/12.92, /(1.055)) ride the same
    # barrier'd _div; pin the sub-threshold linear segment at f32 level
    from kanter_core_tpu.slot_image import _jitted_converters

    x = np.linspace(0.0, 0.04045, 4096, dtype=np.float32)
    packed = np.asarray(_jitted_converters()["gray_to_u8_srgb"](x.reshape(64, 64)))
    v = (packed & 0xFF).astype(np.uint8)
    expect = np.clip(x / np.float32(12.92), 0.0, 1.0) * np.float32(255.0)
    expect = expect.astype(np.uint8).reshape(64, 64)  # truncating cast, Rust `as u8`
    assert np.array_equal(v, expect)


# --- the backend numerics table (ops/exact_math.numerics) -------------------

def test_numerics_cpu_row_is_what_xla_cpu_does():
    """The CPU row is what the gates assume on XLA:CPU — and what the probe
    measures here."""
    from kanter_core_tpu.ops.exact_math import Numerics, numerics
    from kanter_core_tpu.parity import probe_numerics

    assert numerics() is numerics("cpu")
    assert numerics("cpu") == Numerics(
        fma_contracts=True, div_correctly_rounded=True,
        sqrt_correctly_rounded=True, pow_is_glibc=True,
    )
    assert probe_numerics() == numerics("cpu")


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", ""])
def test_numerics_unknown_platform_raises(platform):
    from kanter_core_tpu.ops.exact_math import numerics

    with pytest.raises(ValueError, match="no numerics row"):
        numerics(platform)


def test_numerics_gpu_row_takes_every_correction():
    """The GPU row (measured on an H100): no FMA contraction, so nc_mul is
    a plain multiply; divide, sqrt and pow all need their corrections."""
    from kanter_core_tpu.ops.exact_math import numerics

    row = numerics("gpu")
    assert not row.fma_contracts
    assert not (row.div_correctly_rounded or row.sqrt_correctly_rounded
                or row.pow_is_glibc)


@pytest.mark.parametrize("platform,plain", [("cpu", True), ("gpu", False)])
def test_exact_helpers_follow_the_row(monkeypatch, platform, plain):
    """exact_div/sqrt/pow emit the plain op exactly where the row says the
    hardware op is already right, and nc_mul guards exactly where XLA
    contracts — checked on the traced jaxpr, with the row swapped in."""
    from kanter_core_tpu.ops import exact_math as em

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    x = np.float32(0.3) + np.zeros(4, np.float32)

    def n_eqns(fn, *args):
        # a fresh wrapper per call: make_jaxpr caches traces per function
        return len(jax.make_jaxpr(lambda *a: fn(*a))(*args).eqns)

    assert (n_eqns(em.exact_div, x, x) == 1) == plain
    assert (n_eqns(em.exact_sqrt, x) == 1) == plain
    assert (n_eqns(em.exact_pow, x, x) == 1) == plain
    # nc_mul: one multiply where XLA does not contract (the GPU)
    assert (n_eqns(em.nc_mul, x, x) == 1) == (not plain)


def test_corrected_sqrt_near_midpoint_roots():
    """Near-midpoint roots (x = 4ᵏ·(1 − 2⁻²⁴), 1 ± k ulp): the Newton step
    can round onto an exact midpoint; the tie is decided exactly."""
    from kanter_core_tpu.ops.exact_math import corrected_sqrt

    k = np.arange(1, 1 << 16, dtype=np.float64)
    xs = np.concatenate([
        np.array([np.nextafter(np.float32(4.0) ** e, np.float32(0)) for e in range(-20, 20)],
                 np.float32),
        (1 + k * 2.0 ** -23).astype(np.float32),
        (1 - k * 2.0 ** -24).astype(np.float32),
        np.random.default_rng(0).random(1 << 16, dtype=np.float32),
    ])
    got = np.asarray(jax.jit(corrected_sqrt)(xs))
    assert np.array_equal(got.view(np.uint32), np.sqrt(xs).view(np.uint32))
