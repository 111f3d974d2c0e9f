"""HeightToNormal: gray heightmap → RGB(A) tangent-space normal map.

Mirrors `/root/reference/src/node/height_to_normal.rs`: toroidal-wrap finite
differences sampling up (y-1) and left (x-1) with wraparound
(`height_to_normal.rs:55-56`), tangent/bitangent normalization and cross
product via nalgebra (`:58-60`), remapped as `n * 0.5 + 0.5` (`:63`), alpha
forced to 1 (`from_buffers_rgb`).

The reference's per-pixel scalar loop (its only cancellation-aware kernel)
becomes a fused stencil; cancellation here happens at dispatch granularity
instead of per pixel. Operation order matches nalgebra's
`norm = sqrt((x² + y²) + z²)` and componentwise divide. On CPU plain
sqrt/div are correctly rounded already; the GPU's are up to 1-2 ulp off, so
there the normalizations go through `ops/exact_math.exact_{sqrt,div}` —
making the f32 planes (not just the u8 export) bit-identical across
backends.

Lowering note: XLA fuses the wrap `roll`s into the elementwise chain
without materializing copies, so `jnp.roll` + XLA fusion is the design
here; no hand-written stencil kernel is kept.
"""

from __future__ import annotations

import functools

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .common import slot_data_with_name


def _h2n_jnp(h):
    """jnp implementation (bit-exact vs the Rust scalar loop)."""
    import jax.numpy as jnp

    if h.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        h = h.astype(jnp.float32)
    # roll on a length-1 axis is the identity (see ops/blur._blur_axis0's
    # degenerate-roll note)
    up = h if h.shape[0] == 1 else jnp.roll(h, 1, axis=0)
    return _h2n_core(h, up, *h.shape)


def _h2n_core(h, up, height: int, width: int, left=None, pdx=None, pdy=None):
    """The per-pixel normal math given pre-gathered `up` rows.

    `h`/`up` may be a row band of a larger plane (tiled evaluation gathers
    the wrapped y-1 rows host-side); `height`/`width` are the GLOBAL canvas
    dims (they set the texel step, `height_to_normal.rs:49-52`). Arithmetic
    is identical to evaluating the full plane — bands are bit-transparent.

    The shape-bucketed evaluator (`kanter_core_tpu.bucketed`) additionally
    pre-gathers the x−1 wrap column (`left`, since a roll on a padded-width
    plane would wrap into the pad) and passes HOST-computed f32 texel steps
    (`pdx`/`pdy` as traced scalars — computing 1/width on device would hit
    the GPU's loose division); both default to the formulations above, so the
    non-bucketed paths are unchanged.
    """
    import jax.numpy as jnp

    from .exact_math import nc_mul

    from .exact_math import exact_div as _div, exact_sqrt as _sqrt

    if pdx is None:
        pdx = jnp.float32(1.0) / jnp.float32(width)
    if pdy is None:
        pdy = jnp.float32(1.0) / jnp.float32(height)

    if left is None:
        # sample at (x-1, y) wrapped; identity on a single-column plane
        left = h if h.shape[1] == 1 else jnp.roll(h, 1, axis=1)

    # tangent = normalize([pdx, 0, h - left])
    # pdx²/pdy² go through nc_mul: with STATIC sizes they are compile-time
    # constants either way, but the bucketed path passes pdx/pdy as traced
    # scalars and XLA:CPU's LLVM would contract `pdx*pdx + X` into a
    # one-rounding FMA (measured: 18 f32-bit diffs at 97×411)
    tz = h - left
    tnorm = _sqrt((nc_mul(pdx, pdx) + jnp.float32(0.0)) + nc_mul(tz, tz))
    tx, ty, tzn = _div(pdx, tnorm), _div(jnp.float32(0.0), tnorm), _div(tz, tnorm)

    # bitangent = normalize([0, pdy, up - h])
    bz = up - h
    bnorm = _sqrt((jnp.float32(0.0) + nc_mul(pdy, pdy)) + nc_mul(bz, bz))
    bx, by, bzn = _div(jnp.float32(0.0), bnorm), _div(pdy, bnorm), _div(bz, bnorm)

    # normal = normalize(cross(tangent, bitangent))
    cx = nc_mul(ty, bzn) - nc_mul(tzn, by)
    cy = nc_mul(tzn, bx) - nc_mul(tx, bzn)
    cz = nc_mul(tx, by) - nc_mul(ty, bx)
    cnorm = _sqrt((nc_mul(cx, cx) + nc_mul(cy, cy)) + nc_mul(cz, cz))
    nx, ny, nz = _div(cx, cnorm), _div(cy, cnorm), _div(cz, cnorm)

    half = jnp.float32(0.5)
    from jax import lax

    alpha = lax.optimization_barrier(jnp.ones_like(h))  # see compiler._const_guard
    return (
        nc_mul(nx, half) + half,
        nc_mul(ny, half) + half,
        nc_mul(nz, half) + half,
        alpha,
    )


def h2n_traceable(h):
    """The traceable kernel used by both the eager op and the fused
    compiler. One lowering for every backend (see module docstring)."""
    return _h2n_jnp(h)


@functools.cache
def _kernel():
    import jax

    return jax.jit(h2n_traceable)


def process(shutdown, slot_datas, node):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    if slot_data.image.is_rgba():
        return []  # `height_to_normal.rs:39-43`

    outs = _kernel()(slot_data.image.planes[0].data())
    image = SlotImage([plane_from_device(o) for o in outs])
    return [SlotData(node.node_id, SlotId(0), image)]
