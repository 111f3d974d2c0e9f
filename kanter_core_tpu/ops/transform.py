"""Transform node: affine translate/rotate/scale with seamless wrap
(extension node).

No reference counterpart — the reference's only spatial ops are the resize
policies (`/root/reference/src/node/mod.rs:100-130`) and the wrap stencils
(`height_to_normal.rs:55-56`); every texture authoring tool also offers an
affine placement transform. Design follows the engine's conventions (XLA
lowers the bilinear taps to native gathers):

- **Semantics**: the output pixel at center `(x+0.5, y+0.5)` bilinearly
  samples the input at the INVERSE-transformed coordinate, wrapping
  toroidally at the input's logical extent (the engine's wrap-stencil
  convention). The forward transform rotates by `rotation` degrees and
  scales by `(scale_x, scale_y)` around the canvas center, then translates
  by `(offset_x, offset_y)` pixels.
- **Everything dynamic rides in ARGUMENTS**: `sin/cos` of the angle and
  the reciprocal scales are computed ON THE HOST (numpy — identical bits
  in every consumer; quarter-turn angles hit an exact table so 90/180/270°
  stay gather-exact) and, with the pixel offsets, form the `xform_<id>`
  argument pytree. The trace depends only on shapes, so dragging any of
  the five parameters re-runs one cached executable (the program-cache
  fingerprint normalizes them out, `compiler._normalize_values`).
- **Bit parity across consumers**: the per-pixel coordinate math is pure
  mul/add with `nc_mul` on every product that feeds an add (CLAUDE.md
  contraction rule) in one fixed association; the wrap extents are
  barriered (`lax.optimization_barrier`) because they arrive as trace-time
  constants in the dense/eager/tiled consumers but as runtime scalars in
  the shape-bucketed one — without the barrier the constant folder could
  fold the coordinate chain ~1 ulp off the runtime kernels and flip a
  gather index. No division in the traced path (reciprocals are host-side),
  so f32 planes are bit-identical across backends (parity battery row
  `transform_affine`).
- **Pads are transparent**: wrapped gather indices are always inside the
  LOGICAL extent, so a shape-bucketed padded plane gathers only true
  texels; linear addressing uses the plane's static (padded) width.
- Degenerate scales (`scale == 0`): host reciprocal is ±inf — coordinates
  go non-finite, `floor→clip→i32` keeps the gather index deterministic
  (clamped), matching the Levels node's IEEE-propagation stance.

Output: same planes and size as the input (Gray 1 / RGBA all 4, alpha
transformed like any plane — bilinear of a constant-1 alpha stays 1).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .common import slot_data_with_name
from .exact_math import nc_mul

# exact quarter-turn table: keeps 90/180/270° rotations gather-exact
# (np.cos(pi/2) is ~6e-17, which would smear every texel by 1 ulp)
_QUARTER = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0), 180.0: (-1.0, 0.0), 270.0: (0.0, -1.0)}


def transform_bindings(payload) -> dict:
    """The canonical `xform_<id>` program-argument pytree: `(cos, sin)` of
    the rotation, reciprocal scales, and pixel offsets — all host-computed
    f32 (f64 math, one rounding) so every consumer sees identical bits."""
    ox, oy, deg, sx, sy = (float(v) for v in payload)
    d = deg % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    with np.errstate(divide="ignore"):
        inv = np.float64(1.0) / np.asarray([sx, sy], np.float64)
    return {
        "cs": np.asarray([cos, sin], np.float32),
        "inv_s": inv.astype(np.float32),
        "off": np.asarray([ox, oy], np.float32),
    }


def bilinear_wrap_gather(planes, u, v, wh, ww, row_local=None):
    """Shared bilinear toroidal sampler: `u`/`v` are continuous texel
    coordinates `[nr, nc]` (f32), `wh`/`ww` the barriered i32 wrap extents.
    Extracted verbatim from `transform_planes` (identical op sequence →
    identical jaxpr → the parity-verified bits carry over) so the
    Warp node samples through the exact same formulation.

    `row_local` (optional) remaps the GLOBAL wrapped row indices `y0`/`y1`
    to positions in `planes`' row axis when the planes are a row SUBSET of
    the logical canvas (the tiled band's halo-hoisted rows, a mesh shard's
    halo-extended block). Integer-only and applied after the wrapped global
    index is fixed, so the gathered texels — and therefore every downstream
    lerp bit — are identical to the full-plane gather; `None` emits exactly
    the original jaxpr."""
    import jax.numpy as jnp

    # deterministic i32 conversion: clamp BEFORE the cast (f32→i32 overflow
    # is backend-defined; non-finite coords land here too)
    uf = jnp.clip(jnp.floor(u), -1e9, 1e9)
    vf = jnp.clip(jnp.floor(v), -1e9, 1e9)
    fu = u - uf  # exact (Sterbenz) for in-range coords
    fv = v - vf
    x0 = jnp.mod(uf.astype(jnp.int32), ww)  # floor-mod: wraps negatives
    y0 = jnp.mod(vf.astype(jnp.int32), wh)
    x1 = jnp.where(x0 + 1 == ww, 0, x0 + 1)
    y1 = jnp.where(y0 + 1 == wh, 0, y0 + 1)
    gy0 = y0 if row_local is None else row_local(y0)
    gy1 = y1 if row_local is None else row_local(y1)
    outs = []
    for p in planes:
        if p.dtype != jnp.float32:
            # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
            p = p.astype(jnp.float32)
        stride = p.shape[1]  # static (possibly padded) width for addressing
        flat = p.reshape(-1)
        n00 = flat[gy0 * stride + x0]
        n10 = flat[gy0 * stride + x1]
        n01 = flat[gy1 * stride + x0]
        n11 = flat[gy1 * stride + x1]
        nx0 = n00 + nc_mul(fu, n10 - n00)
        nx1 = n01 + nc_mul(fu, n11 - n01)
        outs.append(nx0 + nc_mul(fv, nx1 - nx0))
    return tuple(outs)


def transform_planes(planes, rows, cols, cs, inv_s, off, wrap_h, wrap_w):
    """Traceable affine-sample of `planes` (each `[Hp, Wp]`, logical extent
    `(wrap_h, wrap_w)`) onto output pixels `rows × cols` (GLOBAL i32 index
    vectors — the tiled evaluator passes a band's absolute rows, the
    bucketed evaluator padded vectors). `cs/inv_s/off` are the f32[2]
    argument vectors from `transform_bindings`; `wrap_h/wrap_w` are the
    input's logical extents (trace-time ints OR runtime i32 scalars)."""
    import jax.numpy as jnp
    from jax import lax

    f32 = jnp.float32
    # barrier the wrap extents: trace-time constants (dense/eager/tiled)
    # must reach the coordinate math as opaque runtime values, like the
    # bucketed path's genuine runtime scalars, or the constant folder
    # reformulates the chain (CLAUDE.md: folder is not bit-identical)
    wh = lax.optimization_barrier(jnp.asarray(wrap_h, jnp.int32))
    ww = lax.optimization_barrier(jnp.asarray(wrap_w, jnp.int32))
    wh_f = wh.astype(f32)
    ww_f = ww.astype(f32)
    cos, sin = cs[0], cs[1]
    cxc = ww_f * f32(0.5)  # canvas center (power-of-two mul: exact)
    cyc = wh_f * f32(0.5)
    cx = cols.astype(f32) + f32(0.5)  # [nc] output pixel centers
    cy = rows.astype(f32) + f32(0.5)  # [nr]
    px = (cx - cxc) - off[0]
    py = (cy - cyc) - off[1]
    # inverse rotation R(−θ), then inverse scale, one fixed association
    qx = nc_mul(px, cos)[None, :] + nc_mul(py, sin)[:, None]  # [nr, nc]
    qy = nc_mul(py, cos)[:, None] - nc_mul(px, sin)[None, :]
    u = nc_mul(qx, inv_s[0]) + (cxc - f32(0.5))  # continuous texel coord
    v = nc_mul(qy, inv_s[1]) + (cyc - f32(0.5))
    return bilinear_wrap_gather(planes, u, v, wh, ww)


@functools.lru_cache(maxsize=8)
def _kernel():
    import jax

    return jax.jit(transform_planes, static_argnums=(6, 7))


def process(slot_datas, node):
    """Eager per-node consumer: same plane count and size as the input."""
    from ..errors import ErrorKind, TexProError

    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        raise TexProError(
            ErrorKind.INVALID_BUFFER_COUNT, "Transform needs an input"
        )
    b = transform_bindings(node.node_type.payload)
    planes = [p.data() for p in slot_data.image.planes]
    h, w = planes[0].shape
    outs = _kernel()(
        tuple(planes),
        np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32),
        b["cs"], b["inv_s"], b["off"], h, w,
    )
    image = SlotImage([plane_from_device(o) for o in outs])
    return [SlotData(node.node_id, SlotId(0), image)]
