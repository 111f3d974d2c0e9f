"""Levels node: per-plane remap `out_lo + (out_hi−out_lo)·t^gamma` where
`t = clip((x−in_lo)/(in_hi−in_lo), 0, 1)` (extension node).

No reference counterpart — the reference's 13 node types stop at Mix; a
levels/gamma adjustment is the most common texture correction after blur.
Design follows the engine's conventions:

- the five parameters are TRACED ARGUMENTS in every consumer (eager jit,
  fused compiler, tiled bands, bucketed) and are normalized out of program
  fingerprints like Value constants — a levels-slider drag re-runs one
  cached executable forever (DESIGN.md §2);
- division and pow go through `exact_math` off-CPU (`corrected_div`,
  `ds_pow`) so f32 planes match XLA:CPU — where plain `/` is IEEE and
  `jnp.power` IS glibc `powf` — up to glibc's own powf misrounds (the same
  allowance as Mix POW, absorbed by u8 export);
- the scaled product feeding the final add goes through `nc_mul` (CLAUDE.md
  rule: a product that feeds an add must be contraction-guarded on CPU);
- applied to EVERY plane (gray 1 / rgba all 4, alpha included — like Blur);
- degenerate span (in_hi == in_lo): IEEE propagation — the divide yields
  ±inf (clip resolves to 1/0) or NaN (propagates), deterministically.

Cost note: on the GPU the op is compute-bound by the correctly-rounded
`ds_pow` (bench_ops `levels` row), the same class as Mix POW. That is the
deliberate price of cross-backend f32-bit determinism (recipe-cache
safety); hardware pow would be ~1 ulp loose.
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


def levels_plane(plane, params):
    """Traceable remap of one `[H, W]` plane; `params` is a traced f32[5]
    vector `(in_lo, in_hi, gamma, out_lo, out_hi)`."""
    import jax.numpy as jnp

    if plane.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        plane = plane.astype(jnp.float32)
    from .exact_math import exact_div as _div, exact_pow as _pow

    in_lo, in_hi, gamma = params[0], params[1], params[2]
    out_lo, out_hi = params[3], params[4]
    t = jnp.clip(_div(plane - in_lo, in_hi - in_lo), 0.0, 1.0)
    # gamma == 1 fast path: the pow IS the op's cost off-CPU (ds_pow's
    # double-single exp/log, far above the traffic floor), and identity
    # gamma is the common
    # slider-at-rest case. Bit-safe by the glibc contract: powf(x, 1.0)
    # is special-cased to x exactly, so the CPU golden path is unchanged
    # bit-for-bit and the off-CPU cond matches CPU exactly (parity battery
    # row `levels_identity_gamma`). `lax.cond` executes ONE branch per call (under
    # vmap it degrades to select — both branches — which only restores
    # the old cost); NaN gamma takes the pow path unchanged.
    from jax import lax

    t = lax.cond(
        gamma == jnp.float32(1.0),
        lambda t_: t_,
        lambda t_: _pow(t_, gamma),
        t,
    )
    return out_lo + nc_mul(out_hi - out_lo, t)


@functools.lru_cache(maxsize=8)  # keyed by plane count only; params are args
def _kernel(planes: int):
    import jax

    def f(params, *ps):
        return tuple(levels_plane(p, params) for p in ps)

    return jax.jit(f)


def process(slot_datas, node):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    params = np.asarray(node.node_type.payload, np.float32)
    planes = [p.data() for p in slot_data.image.planes]
    outs = _kernel(len(planes))(params, *planes)
    image = SlotImage([plane_from_device(o) for o in outs])
    return [SlotData(node.node_id, SlotId(0), image)]
