"""Hsv node: hue-rotate / saturation-scale / value-scale color adjust
(extension node — the reference's 13 node types stop at Mix; an HSV adjust
is the standard color correction in texture tools, next to Levels).

RGBA in → RGBA out through the classic hexcone transform; gray in → the
value scale only (a gray pixel has saturation 0 and no hue, so the full
transform degenerates to exactly that). Alpha passes through untouched.

Bit-determinism design (CLAUDE.md numerics rules):

- **Hue lives in SECTOR units** (`h6 ∈ [0, 6)`, one unit per hexcone
  sector) end to end, so there is NO division by the constant 6 anywhere —
  XLA:CPU rewrites constant divisors into reciprocal multiplies (measured
  f32 drift, see CLAUDE.md), and barriers are a cost; sector units remove
  the hazard instead. The user-facing hue shift is DEGREES, converted
  host-side in f64 (`hsv_bindings`, like Transform's host-side trig).
- The only divisions (`delta/maxc`, `(x−y)/delta`) have RUNTIME divisors:
  plain `/` on CPU (hardware IEEE), `corrected_div` elsewhere.
- Wrap/mod is select-plus-exact-subtract (`where(x ≥ 6, x − 6, x)` on
  sums bounded < 12), never fmod; sector index/fraction come from exact
  `floor`/subtract.
- Products feeding adds/subtracts go through `nc_mul` (anti-FMA); terminal
  products (`v·(1−s)` into a select) are plain single-rounding muls.
- Degenerate pixels are IEEE-deterministic: `delta == 0` (gray) selects
  hue 0, `maxc == 0` (black) selects saturation 0 — the discarded branch
  may compute NaN/inf, `where` drops it identically on every backend.
- `saturation`/`value` results clip to [0, 1]; NaN inputs propagate.

The three parameters ride as ONE program argument (f32[3] `hsv_<id>`:
sector shift, saturation scale, value scale) in every traced consumer, so
slider drags re-run cached executables; nothing about the node shapes the
trace. Elementwise in the pixel — tiled bands map rows 1:1 and bucketed
pads are bit-transparent by construction.
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


def hsv_bindings(payload) -> np.ndarray:
    """The canonical `hsv_<id>` program argument: `(shift6, sat, val)` with
    the degree shift normalized to sectors in f64 HOST math (one rounding
    to f32) — identical bits in eager/fused/tiled/bucketed because numpy
    computes it, not XLA."""
    hue_deg, sat, val = payload
    shift6 = (np.float64(hue_deg) % 360.0 + 360.0) % 360.0 / 60.0
    return np.asarray([np.float32(shift6), np.float32(sat), np.float32(val)],
                      np.float32)


def _f32(p):
    import jax.numpy as jnp

    # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
    return p if p.dtype == jnp.float32 else p.astype(jnp.float32)


def hsv_planes(planes, params):
    """Traceable adjust of a 1- or 4-plane pixel stack; `params` is the
    traced f32[3] vector from `hsv_bindings`. Returns the same number of
    planes; alpha (plane 3) is passed through by reference."""
    import jax.numpy as jnp

    f32 = jnp.float32
    shift6, sat, val = params[0], params[1], params[2]

    if len(planes) == 1:
        # gray: saturation 0, no hue — exactly the value scale
        return [jnp.clip(_f32(planes[0]) * val, 0.0, 1.0)]

    from .exact_math import exact_div as _div  # runtime divisors only

    r, g, b = _f32(planes[0]), _f32(planes[1]), _f32(planes[2])
    maxc = jnp.maximum(r, jnp.maximum(g, b))
    minc = jnp.minimum(r, jnp.minimum(g, b))
    delta = maxc - minc  # exact

    # hue in sectors: classic piecewise, ties resolve in r→g→b order (the
    # same select tree on every backend)
    safe = jnp.where(delta == 0.0, f32(1.0), delta)
    h6 = jnp.where(
        delta == 0.0,
        f32(0.0),
        jnp.where(
            maxc == r,
            _div(g - b, safe),              # (-1, 1): wrapped below
            jnp.where(
                maxc == g,
                f32(2.0) + _div(b - r, safe),
                f32(4.0) + _div(r - g, safe),
            ),
        ),
    )
    h6 = jnp.where(h6 < 0.0, h6 + f32(6.0), h6)  # exact add: now [0, 6)

    s = jnp.where(maxc == 0.0, f32(0.0), _div(delta, maxc))

    # adjust: shift sectors (sum < 12 → one conditional exact subtract),
    # scale+clip saturation/value
    hh = h6 + shift6
    hh = jnp.where(hh >= 6.0, hh - f32(6.0), hh)
    # plain muls: the products feed clip (max/min), never an add
    ss = jnp.clip(s * sat, 0.0, 1.0)
    vv = jnp.clip(maxc * val, 0.0, 1.0)

    # hexcone reconstruction: sector index/fraction from exact floor/sub
    sec = jnp.floor(hh)
    i = jnp.clip(sec.astype(jnp.int32), 0, 5)
    f = hh - sec  # exact
    p = vv * (f32(1.0) - ss)
    q = vv * (f32(1.0) - nc_mul(ss, f))
    t = vv * (f32(1.0) - nc_mul(ss, f32(1.0) - f))

    def pick(table):
        out = table[5]
        for k in (4, 3, 2, 1, 0):
            out = jnp.where(i == k, table[k], out)
        return out

    out = [
        pick((vv, q, p, p, t, vv)),
        pick((t, vv, vv, q, p, p)),
        pick((p, p, t, vv, vv, q)),
    ]
    if len(planes) == 4:
        out.append(planes[3])  # alpha passes through (aliases the input)
    return out


@functools.lru_cache(maxsize=8)  # keyed by plane count only; params are args
def _kernel(planes: int):
    import jax

    def fn(params, *ps):
        return tuple(hsv_planes(list(ps), params))

    return jax.jit(fn)


def process(slot_datas, node):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    params = hsv_bindings(node.node_type.payload)
    in_planes = slot_data.image.planes
    # alpha never enters the kernel: the stored PlaneBuffer is ALIASED
    # into the output (zero copy, stored dtype preserved — aliasing ops
    # must not cast, CLAUDE.md bf16 rule)
    compute = in_planes[:3] if len(in_planes) == 4 else in_planes
    outs = _kernel(len(compute))(params, *(p.data() for p in compute))
    planes = [plane_from_device(o) for o in outs]
    if len(in_planes) == 4:
        planes.append(in_planes[3])
    return [SlotData(node.node_id, SlotId(0), SlotImage(planes))]
