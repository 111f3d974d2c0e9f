"""GradientMap node: gray → RGBA through N lerped color stops (extension).

No reference counterpart — the reference's type system distinguishes Gray
and Rgba (`/root/reference/src/slot_image.rs:16`) but its only gray→rgba
mappings are the aliasing expansion (`as_type`) and HeightToNormal; a
gradient map (colorize ramp) is THE standard way texture tools turn a
procedural height/mask into albedo. Design follows the engine's
conventions:

- the stop table (positions f32[N] + colors f32[4, N]) is a TRACED
  ARGUMENT in every consumer, normalized out of program fingerprints like
  Value constants — dragging a stop's position or color re-runs one
  cached executable; only the stop COUNT shapes the trace (DESIGN.md §2);
- evaluation is a where-select over segments (never a telescoped
  cumulative sum, whose f32 partials wouldn't hit interior stop colors
  within a segment's endpoints deterministically): start from the first
  stop's color, and for each segment k emit
  `c_k + t·(c_{k+1} − c_k)`, `t = clip((x − p_k)/(p_{k+1} − p_k), 0, 1)`,
  selected where `x ≥ p_k`. Below the first stop → first color; above the
  last → the last segment at t = 1 (which is `c_{N−2} + (c_{N−1} − c_{N−2})`,
  the f32 lerp endpoint — may differ from `c_{N−1}` by 1 ulp, as in any
  lerp formulation);
- the division routes through `exact_div` (runtime divisor) and the lerp
  product through `nc_mul` (CLAUDE.md contraction rule), so f32 planes
  are bit-identical across backends (parity battery row `gradient_map`);
- degenerate stops (p_{k+1} == p_k): IEEE propagation — the divide yields
  ±inf (clip resolves to 1/0) or NaN (propagates), deterministically.
  NaN input pixels select no segment (all compares false) and resolve to
  the first stop's color.

Output: RGBA (4 planes) at the input's size. Input must be Gray — the
traced consumers raise INVALID_BUFFER_COUNT on an RGBA input, like
HeightToNormal.
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


def gradient_bindings(payload) -> dict:
    """The canonical `grad_<id>` program-argument pytree: sorted stop
    positions f32[N] and colors f32[4, N] (channel-major so each channel's
    stop row is contiguous)."""
    stops = payload
    pos = np.asarray([s[0] for s in stops], np.float32)
    colors = np.asarray([[s[1 + c] for s in stops] for c in range(4)], np.float32)
    return {"pos": pos, "colors": colors}


def gradient_planes(plane, pos, colors):
    """Traceable gradient map of one gray `[H, W]` plane → 4 RGBA planes.
    `pos` f32[N] ascending stop positions, `colors` f32[4, N]."""
    import jax.numpy as jnp

    if plane.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        plane = plane.astype(jnp.float32)
    from .exact_math import exact_div as _div  # runtime divisors only

    n = pos.shape[0]
    outs = []
    for c in range(4):
        out = jnp.broadcast_to(colors[c, 0], plane.shape)
        for k in range(n - 1):
            t = jnp.clip(_div(plane - pos[k], pos[k + 1] - pos[k]), 0.0, 1.0)
            seg = colors[c, k] + nc_mul(t, colors[c, k + 1] - colors[c, k])
            out = jnp.where(plane >= pos[k], seg, out)
        outs.append(out)
    return tuple(outs)


@functools.lru_cache(maxsize=8)
def _kernel():
    import jax

    return jax.jit(gradient_planes)


def process(slot_datas, node):
    """Eager per-node consumer: gray input → RGBA SlotData."""
    from ..errors import ErrorKind, TexProError

    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None or len(slot_data.image.planes) != 1:
        raise TexProError(
            ErrorKind.INVALID_BUFFER_COUNT, "GradientMap needs a Gray input"
        )
    b = gradient_bindings(node.node_type.payload)
    outs = _kernel()(slot_data.image.planes[0].data(), b["pos"], b["colors"])
    image = SlotImage([plane_from_device(o) for o in outs])
    return [SlotData(node.node_id, SlotId(0), image)]
