"""Mix op: Add/Subtract/Multiply/Divide/Pow over two images.

Mirrors `/root/reference/src/node/mix.rs`. The per-pixel loops of the
reference become one fused XLA kernel per (mix type, gray/rgba) — IEEE f32
semantics are preserved exactly (divide-by-zero produces ±inf/NaN, which the
goldens encode; `mix.rs:179`).

Missing-input defaults (`mix.rs:56-84`):
- only `left`: right = 0.0-image of left's type (left's size);
- only `right`: left = 0.0-image of right's type; right keeps its own type;
- neither: single 1×1 gray 0.0 output.
The RGBA variant computes the three color channels and forces alpha to 1.0
(`mix.rs:194-213`).

Extension blend modes (no reference counterpart): Darken/Lighten/Difference/
Screen/Overlay — the classic compositing modes every texture tool ships,
added as extra MixType variants so they inherit the whole Mix contract
(missing-input defaults, gray/rgba coercion, alpha=1.0) and ride through all
four lockstep consumers via this module's `_binary`. Formulations are chosen
for cross-backend bit parity (see the comment in `_binary`).
"""

from __future__ import annotations

import functools

from ..ids import SlotId
from ..node import MixType
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .common import slot_data_with_name
from .exact_math import corrected_div, exact_pow, nc_mul


def _f32_operands(op):
    """Upcast half-precision operands before the op (DESIGN.md §9: bf16 at
    rest, f32 in flight) — a fresh convert per call site, which XLA fuses
    into the consumer (a shared upcast tracer would materialize). No-op for
    the f32 default pipeline."""

    def wrapped(l, r):
        import jax.numpy as jnp

        if l.dtype != jnp.float32:
            l = l.astype(jnp.float32)
        if r.dtype != jnp.float32:
            r = r.astype(jnp.float32)
        return op(l, r)

    return wrapped


def _binary(mix_type: MixType):
    import jax.numpy as jnp

    # Plain XLA f32 add/sub/mul are bit-identical to the reference's Rust f32
    # math on every backend. Divide and pow are not on the GPU (~1-2 ulp):
    # DIVIDE always goes through the Dekker-corrected division (bit-exact vs
    # glibc on both CPU and GPU, and provably identical to plain hardware
    # division where that is already correctly rounded); POW goes through
    # `exact_pow` — glibc's powf where XLA calls it (CPU), the
    # correctly-rounded double-single expansion elsewhere; the two differ
    # on the handful of inputs glibc misrounds. See ops/exact_math.py for
    # the measurements.
    if mix_type == MixType.ADD:
        return _f32_operands(lambda l, r: l + r)
    if mix_type == MixType.SUBTRACT:
        return _f32_operands(lambda l, r: l - r)
    if mix_type == MixType.MULTIPLY:
        # nc_mul, not a bare `l * r`: value-identical everywhere (plain mul
        # on the GPU), but on XLA:CPU the Dekker guard stops LLVM from
        # contracting the product into a consumer's add/sub as a
        # one-rounding FMA. Measured: with the product exposed to inlining
        # (the bucketed evaluator's gather-argument data movement),
        # Mix(MULTIPLY)→HeightToNormal produced 43 f32-bit diffs at 97×411;
        # the roll-based paths only avoided it because rolls force the
        # operand to materialize. CLAUDE.md's rule applied: any product
        # that can feed an add goes through nc_mul on CPU.
        return _f32_operands(nc_mul)
    if mix_type == MixType.DIVIDE:
        return _f32_operands(corrected_div)
    if mix_type == MixType.POW:
        return _f32_operands(exact_pow)
    # --- extension blend modes (no reference counterpart; the classic
    # compositing formulas on straight channels). Every formulation is a
    # fixed association of exact two-rounding ops (min/max/abs/add/sub,
    # exact ×2) with nc_mul on every product — min/max/abs are bit-exact on
    # both backends and nc_mul blocks LLVM's FMA contraction on CPU (it
    # contracts even through a select — CLAUDE.md), so f32 planes stay
    # bit-identical across CPU/GPU and all four lockstep consumers. NaN/inf
    # propagate IEEE-style (matching Mix DIVIDE's stance); note jnp.minimum/
    # maximum return NaN when either operand is NaN, and `NaN < 0.5` is
    # False so Overlay's select resolves to the high branch deterministically.
    if mix_type == MixType.DARKEN:
        return _f32_operands(jnp.minimum)
    if mix_type == MixType.LIGHTEN:
        return _f32_operands(jnp.maximum)
    if mix_type == MixType.DIFFERENCE:
        return _f32_operands(lambda l, r: jnp.abs(l - r))
    if mix_type == MixType.SCREEN:
        # 1 − (1−l)(1−r), formulated as l + (1−l)·r: one sub, one guarded
        # product, one add — the product feeds the add, hence nc_mul
        return _f32_operands(
            lambda l, r: l + nc_mul(jnp.float32(1.0) - l, r)
        )
    if mix_type == MixType.OVERLAY:

        def _overlay(l, r):
            two = jnp.float32(2.0)  # power-of-two scale: exact
            one = jnp.float32(1.0)
            lo = nc_mul(l, r) * two
            hi = one - nc_mul(one - l, one - r) * two
            return jnp.where(l < jnp.float32(0.5), lo, hi)

        return _f32_operands(_overlay)
    raise ValueError(mix_type)


@functools.cache
def _gray_kernel(mix_type: MixType):
    import jax

    return jax.jit(_binary(mix_type))


@functools.cache
def _rgba_kernel(mix_type: MixType):
    import jax
    import jax.numpy as jnp

    op = _binary(mix_type)

    @jax.jit
    def kernel(l0, l1, l2, r0, r1, r2):
        alpha = jnp.ones_like(l0)
        return op(l0, r0), op(l1, r1), op(l2, r2), alpha

    return kernel


def mix_images(image_left: SlotImage, image_right: SlotImage, mix_type: MixType) -> SlotImage | None:
    """Apply the mix kernel to two same-type images; None on type mismatch."""
    if not image_left.is_rgba() and not image_right.is_rgba():
        out = _gray_kernel(mix_type)(image_left.planes[0].data(), image_right.planes[0].data())
        return SlotImage([plane_from_device(out)])
    if image_left.is_rgba() and image_right.is_rgba():
        l = [p.data() for p in image_left.planes[:3]]
        r = [p.data() for p in image_right.planes[:3]]
        outs = _rgba_kernel(mix_type)(*l, *r)
        return SlotImage([plane_from_device(o) for o in outs])
    return None  # `mix.rs:126` — mismatched types yield no outputs


def process(slot_datas, node, mix_type: MixType):
    from ..geometry import Size

    left_data = slot_data_with_name(slot_datas, node, "left")
    right_data = slot_data_with_name(slot_datas, node, "right")

    if left_data is not None:
        is_rgba = left_data.image.is_rgba()
        if right_data is not None:
            image_right = right_data.image.as_type(is_rgba)
        else:
            image_right = SlotImage.from_value(left_data.size(), 0.0, is_rgba)
        image_left = left_data.image
    elif right_data is not None:
        image_left = SlotImage.from_value(right_data.size(), 0.0, right_data.image.is_rgba())
        image_right = right_data.image
    else:
        return [SlotData(node.node_id, SlotId(0), SlotImage.from_value(Size(1, 1), 0.0, False))]

    result = mix_images(image_left, image_right, mix_type)
    if result is None:
        return []
    return [SlotData(node.node_id, SlotId(0), result)]
