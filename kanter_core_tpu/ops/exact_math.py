"""Correctly-rounded f32 arithmetic on backends whose hardware ops are not.

The reference's pixel math is Rust f32 linked against glibc (`mix.rs:136-192`
does plain `/` and `powf`). XLA:CPU matches glibc bit-for-bit (verified over
the full u8-decoded grid — see DESIGN.md §7). XLA:GPU does not: its f32
divide is up to 2 ulp off, its sqrt up to 1 ulp, and its pow (libdevice)
up to 1 ulp from glibc's powf. This module recovers reference-grade rounding
ON DEVICE with double-single arithmetic: every intermediate is an
unevaluated pair of f32s (~49 significant bits), built from plain add/mul —
no FMA, no f64, no host callbacks, fully fusable and vmappable.

Which backend needs which correction is one table, `numerics()`, keyed by
the platform and read at trace time; the ops ask it for a property, never
for a backend name. Measured on an H100 (NVIDIA H100 80GB HBM3, 400 W limit)
over 2²⁰ random and all 65536 u8-decoded input pairs:
- `corrected_div`, `corrected_sqrt`: 0 f32-bit mismatches vs IEEE;
- `ds_pow`: bit-identical to XLA:CPU's `ds_pow`, and 48 f32-bit mismatches
  vs glibc on the u8 grid — every one a case where glibc's powf (max error
  ~0.82 ulp) itself misrounds while ds_pow returns the correctly-rounded
  value; after u8 export quantization the two agree on ALL 65536 pairs;
- XLA:GPU and Pallas-Triton kernels keep `a*b + c` two-rounded (0 of
  246,559 FMA-sensitive triples contracted), so `nc_mul` needs no guard there.

Non-f32 dtypes (the opt-in bf16 pipeline, DESIGN.md §9): the machinery is
pointless below f32 precision — a bf16 result rounds away any sub-ulp-of-f32
correction, and the Veltkamp constants assume the f32 mantissa width. Every
helper therefore passes straight through to the plain op when the operands'
result type isn't float32 (a trace-time decision; half-precision mode is
documented as non-bit-exact).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _const_ds(value) -> tuple:
    """Split a float64 constant into an exact (hi, lo) f32 pair."""
    v = np.float64(value)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return float(hi), float(lo)


@dataclasses.dataclass(frozen=True)
class Numerics:
    """What a backend's compiled f32 arithmetic does, as the ops need it."""

    #: XLA fuses an f32 multiply feeding an add into one FMA (one rounding)
    fma_contracts: bool
    #: plain f32 `/` with a runtime divisor is correctly rounded (IEEE)
    div_correctly_rounded: bool
    #: plain f32 `sqrt` is correctly rounded (IEEE)
    sqrt_correctly_rounded: bool
    #: plain f32 `pow` equals glibc's `powf` bit for bit
    pow_is_glibc: bool


#: one row per platform; the GPU row is measured on an H100 by
#: `kanter_core_tpu.parity.probe_numerics` (run by `chip_smoke.py`)
NUMERICS = {
    "cpu": Numerics(fma_contracts=True, div_correctly_rounded=True,
                    sqrt_correctly_rounded=True, pow_is_glibc=True),
    "gpu": Numerics(fma_contracts=False, div_correctly_rounded=False,
                    sqrt_correctly_rounded=False, pow_is_glibc=False),
}


def numerics(platform: str | None = None) -> Numerics:
    """The `Numerics` row of `platform` (default: JAX's default backend,
    read at trace time). A platform without a measured row is an error."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return NUMERICS[platform]
    except KeyError:
        raise ValueError(
            f"no numerics row for platform {platform!r}; measure one with "
            "kanter_core_tpu.parity.probe_numerics"
        ) from None


def exact_div(a, b):
    """f32 division rounded like glibc: the plain op where the backend's is
    correctly rounded, `corrected_div` elsewhere. For RUNTIME divisors only:
    XLA rewrites division by a compile-time constant into a reciprocal
    multiply, so constant divisors need an `optimization_barrier` too."""
    return a / b if numerics().div_correctly_rounded else corrected_div(a, b)


def exact_sqrt(x):
    """f32 sqrt rounded like glibc (see `exact_div`)."""
    import jax.numpy as jnp

    return jnp.sqrt(x) if numerics().sqrt_correctly_rounded else corrected_sqrt(x)


def exact_pow(a, b):
    """f32 pow as glibc's powf where the backend's is glibc's, else the
    correctly-rounded `ds_pow` (which differs from glibc only where glibc
    misrounds; u8 export absorbs every such case)."""
    import jax.numpy as jnp

    return jnp.power(a, b) if numerics().pow_is_glibc else ds_pow(a, b)


def _exactness_applies(*operands) -> bool:
    """True when the f32 correction machinery is meaningful for these
    operands (trace-time static: dtypes are shape metadata under jit)."""
    import jax.numpy as jnp

    return jnp.result_type(*operands) == jnp.float32


_LN2 = _const_ds("0.693147180559945309417232121458")
_INV_LN2 = _const_ds("1.442695040888963407359924681002")
_ATANH_COEF = [_const_ds(1.0 / k) for k in range(3, 25, 2)]
_EXP_COEF = [_const_ds(1.0 / math.factorial(k)) for k in range(2, 15)]


def _ds_ops(jnp):
    f32 = jnp.float32

    def two_sum(x, y):
        s = x + y
        yy = s - x
        return s, (x - (s - yy)) + (y - yy)

    def quick_two_sum(x, y):  # requires |x| >= |y|
        s = x + y
        return s, y - (s - x)

    def split(x):
        t = f32(4097.0) * x  # 2^12 + 1: Veltkamp constant for f32
        hi = t - (t - x)
        return hi, x - hi

    def two_prod(x, y):
        p = x * y
        xh, xl = split(x)
        yh, yl = split(y)
        return p, ((xh * yh - p) + xh * yl + xl * yh) + xl * yl

    def ds_add(x, y):
        s, e = two_sum(x[0], y[0])
        return quick_two_sum(s, e + (x[1] + y[1]))

    def ds_mul(x, y):
        p, e = two_prod(x[0], y[0])
        return quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))

    def ds_div(x, y):
        q0 = x[0] / y[0]
        p = ds_mul((q0, jnp.zeros_like(q0)), y)
        r = ds_add(x, (-p[0], -p[1]))
        return quick_two_sum(q0, (r[0] + r[1]) / y[0])

    return two_sum, quick_two_sum, split, two_prod, ds_add, ds_mul, ds_div


def corrected_div(a, b):
    """Correctly-rounded f32 division (one Dekker-refined step, no FMA).

    q0 = a/b, then q0 + (a − q0·b)/b where the residual is EXACT via
    Veltkamp splitting. Non-finite q0 (x/0, 0/0) passes through untouched to
    keep IEEE inf/NaN encoding. Verified 0/65536 grid and 0/1e6 wide-range
    mismatches vs glibc on both XLA:CPU and an H100.
    """
    import jax.numpy as jnp

    if not _exactness_applies(a, b):
        return a / b

    two_sum, quick_two_sum, split, two_prod, ds_add, ds_mul, ds_div = _ds_ops(jnp)
    q0 = a / b
    qh, ql = split(q0)
    bh, bl = split(b)
    prod = q0 * b
    err = ((qh * bh - prod) + qh * bl + ql * bh) + ql * bl
    r = (a - prod) - err
    corr = r / b
    q = q0 + corr
    # fall back to the plain quotient wherever the refinement machinery
    # produced non-finite intermediates: b = ±inf (q0 = 0 exactly right,
    # but split(inf) → NaN), or |q0|/|b| beyond the Veltkamp-splittable
    # range (4097·x overflows above ~8.3e34). In those regions q0 is
    # already correct (x/inf = 0 exactly) or within hardware rounding of
    # magnitudes no texture pipeline reaches; returning NaN was wrong on
    # EVERY backend. The finite-domain path is bit-unchanged.
    return jnp.where(jnp.isfinite(q0) & jnp.isfinite(corr), q, q0)


def nc_mul(x, y):
    """Non-contractible f32 multiply: exactly fl(x·y), immune to FMA fusion.

    XLA:CPU (via LLVM) contracts `a*b + c` into fma(a, b, c) — ONE rounding,
    where the reference's Rust (no fast-math) and numpy do TWO. This
    helper forces the separately-rounded product everywhere: the product
    additionally feeds a Dekker error term and returns `p + (err − err)`.
    Strict FP semantics protect the construction — a compiler may fold
    neither `err − err → 0` (NaN/inf operands) nor `p + 0.0 → p` (signed
    zero), and the consumer add sees an fadd result, not an fmul, so the
    contraction pattern never matches. Verified 0/1e6 mismatches vs numpy's
    two-rounding `a*b + c` on XLA:CPU.

    Where XLA does not contract (`numerics().fma_contracts` is False, as on
    the GPU) the guard is unnecessary and costs ~14 flops per product, so the
    plain multiply is emitted; the device parity battery
    (`kanter_core_tpu.parity`) pins the two forms bit-equal across backends.
    """
    import jax.numpy as jnp

    if not _exactness_applies(x, y) or not numerics().fma_contracts:
        return x * y

    f32 = jnp.float32
    p = x * y
    t = f32(4097.0) * x
    xh = t - (t - x)
    xl = x - xh
    t = f32(4097.0) * y
    yh = t - (t - y)
    yl = y - yh
    err = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    # the err term is a DECOY (err − err == +0.0; only the fadd in the
    # return blocks contraction) — but a non-finite err (inf/NaN operand,
    # or |x|,|y| past the ~8.3e34 Veltkamp-splittable bound) made
    # p + (NaN − NaN) = NaN where Rust's two-rounding gives ±inf.
    # Sanitize it; the select's runtime condition keeps the compiler from
    # folding err − err statically, so the anti-FMA construction stands.
    # (Known quirk, pre-existing: a −0.0 product returns +0.0 here — the
    # fadd with +0.0 — while Rust keeps −0.0; u8 export masks it.)
    err = jnp.where(jnp.isfinite(err), err, f32(0.0))
    return p + (err - err)


def corrected_sqrt(x):
    """Correctly-rounded f32 sqrt (GPU hardware sqrt is ~1 ulp off on ~17%
    of inputs). One Newton refinement with the EXACT residual x − s0² via
    Veltkamp splitting: s = s0 + (x − s0²)/(2·s0). Correct rounding follows
    because √x is never exactly at an f32 rounding midpoint (a classical
    result: a midpoint squared needs 2p+2 mantissa bits). Non-finite or
    zero s0 (x ≤ 0, inf, NaN) passes through untouched.
    """
    import jax.numpy as jnp

    if not _exactness_applies(x):
        return jnp.sqrt(x)

    s0 = jnp.sqrt(x)
    sh_t = jnp.float32(4097.0) * s0
    sh = sh_t - (sh_t - s0)
    sl = s0 - sh
    prod = s0 * s0
    err = ((sh * sh - prod) + sh * sl + sl * sh) + sl * sl
    r = (x - prod) - err
    corr = r / (s0 + s0)
    s = s0 + corr
    # near-midpoint roots (x = 1 − 2⁻²⁴, x = 4ᵏ·(1 − 2⁻²⁴), …): corr can
    # round so that s0 + corr lands exactly on a midpoint, and the add then
    # ties to even whichever side √x is on. Decide such ties exactly: e is
    # the add's exact error (m = s + e is the midpoint), and
    # x − m² = (x − s²) − 2·s·e − e², whose first two terms are exact here.
    bb = s - s0
    e = (s0 - (s - bb)) + (corr - bb)
    gap = jnp.nextafter(s, jnp.where(e > 0, jnp.inf, -jnp.inf).astype(s.dtype)) - s
    th_t = jnp.float32(4097.0) * s
    th = th_t - (th_t - s)
    tl = s - th
    ps = s * s
    q = ((x - ps) - (((th * th - ps) + th * tl + tl * th) + tl * tl)) - (s + s) * e
    beyond = jnp.where(e > 0, q > e * e, q < e * e)
    s = jnp.where((e != 0) & (e + e == gap) & beyond, s + gap, s)
    return jnp.where(jnp.isfinite(s0) & (s0 > 0), s, s0)


def _ds_pow_core(a, b):
    """exp2(b · log2(a)) in double-single, for a > 0 finite, b finite."""
    import jax.numpy as jnp

    f32 = jnp.float32
    two_sum, quick_two_sum, split, two_prod, ds_add, ds_mul, ds_div = _ds_ops(jnp)

    def C(c):
        return (f32(c[0]), f32(c[1]))

    one = (f32(1.0), f32(0.0))

    # log2(a): a = m·2^e with m ∈ [√0.5, √2) so |r| ≤ 0.1716
    m, e = jnp.frexp(a)
    lo_m = m < f32(0.70710678)
    m = jnp.where(lo_m, m * f32(2.0), m)
    e = jnp.where(lo_m, e - 1, e).astype(jnp.float32)

    num = (m - f32(1.0), jnp.zeros_like(m))  # exact by Sterbenz
    den = two_sum(m, f32(1.0))
    r = ds_div(num, den)
    r2 = ds_mul(r, r)

    # ln(m) = 2·atanh(r): Horner over r² with DS coefficients 1/3, 1/5, …
    acc = C(_ATANH_COEF[-1])
    for coef in reversed(_ATANH_COEF[:-1]):
        acc = ds_add(ds_mul(acc, r2), C(coef))
    acc = ds_add(ds_mul(acc, r2), one)
    ln_m = ds_mul(r, acc)
    ln_m = (ln_m[0] * f32(2.0), ln_m[1] * f32(2.0))  # exact ×2

    log2_a = ds_add(ds_mul(ln_m, C(_INV_LN2)), (e, jnp.zeros_like(e)))

    # exp2(t), t = b·log2(a): t = n + f with |f| ≤ 0.5, exp(f·ln2) by series
    t = ds_mul(log2_a, (b, jnp.zeros_like(b)))
    n = jnp.round(t[0])
    f = ds_add(t, (-n, jnp.zeros_like(n)))
    u = ds_mul(f, C(_LN2))

    acc = C(_EXP_COEF[-1])
    for coef in reversed(_EXP_COEF[:-1]):
        acc = ds_add(ds_mul(acc, u), C(coef))
    acc = ds_add(ds_mul(acc, u), one)   # 1 + u·(1/2! + u·(1/3! + …))
    expu = ds_add(ds_mul(acc, u), one)  # 1 + u + u²/2! + …

    n_i = n.astype(jnp.int32)
    return jnp.ldexp(expu[0], n_i) + jnp.ldexp(expu[1], n_i)


def ds_pow(a, b):
    """f32 pow with glibc powf special-case semantics and a correctly-rounded
    normal path (`_ds_pow_core`). Handles: b=0 → 1 (any a, incl. NaN), a=1 →
    1 (any b), negative a with integer b (sign by parity, NaN otherwise),
    ±0 and ±inf bases, NaN propagation."""
    import jax.numpy as jnp

    if not _exactness_applies(a, b):
        return jnp.power(a, b)

    f32 = jnp.float32
    nan, inf = f32(np.nan), f32(np.inf)

    normal = (a > 0) & jnp.isfinite(a) & jnp.isfinite(b)
    abs_a = jnp.abs(a)
    safe_a = jnp.where(abs_a > 0, abs_a, f32(1.0))
    core = _ds_pow_core(safe_a, b)

    b_int = jnp.floor(b) == b
    b_odd = b_int & (jnp.floor(b / 2.0) * 2.0 != jnp.floor(b))
    neg_pow = jnp.where(b_int, jnp.where(b_odd, -core, core), nan)

    out = jnp.where(normal, core, nan)
    out = jnp.where((a < 0) & jnp.isfinite(a) & jnp.isfinite(b), neg_pow, out)
    # b = ±inf: |a| < 1 → {0, inf}, |a| > 1 → {inf, 0}, |a| = 1 → 1
    mag = jnp.abs(a)
    out = jnp.where(
        b == inf,
        jnp.where(mag == 1, f32(1.0), jnp.where(mag > 1, inf, f32(0.0))),
        out,
    )
    out = jnp.where(
        b == -inf,
        jnp.where(mag == 1, f32(1.0), jnp.where(mag > 1, f32(0.0), inf)),
        out,
    )
    # pow(±0, y): ±inf for y < 0, ±0 for y > 0 — the sign transfers only
    # for odd-integer y (IEEE 754 pow)
    zero_sign = jnp.where(b_odd & jnp.signbit(a), f32(-1.0), f32(1.0))
    out = jnp.where(a == 0, zero_sign * jnp.where(b < 0, inf, f32(0.0)), out)
    out = jnp.where(a == inf, jnp.where(b < 0, f32(0.0), inf), out)
    out = jnp.where(
        a == -inf,
        jnp.where(b_odd, f32(-1.0), f32(1.0)) * jnp.where(b < 0, f32(0.0), inf),
        out,
    )
    out = jnp.where(jnp.isnan(a) | jnp.isnan(b), nan, out)
    out = jnp.where(a == f32(1.0), f32(1.0), out)
    out = jnp.where(b == 0, f32(1.0), out)
    return out
