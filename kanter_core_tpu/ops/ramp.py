"""Ramp node: procedural gradient source (extension node).

No reference counterpart — the reference's only procedural source is the
1×1 Value constant (`/root/reference/src/node/value.rs:14-26`), and until
this node the framework had organic (Noise), structured (Pattern), and
cellular (Voronoi) sources but NO plain coordinate gradient: there was no
way to author a linear fade, radial vignette, or box mask without an
image file. One Gray output in [0, 1] over NORMALIZED canvas coordinates
`(u, v) = ((col+0.5)/W, (row+0.5)/H)`:

- kind `Linear`:  `clip(0.5 + scale·((u−cx)·cosθ + (v−cy)·sinθ), 0, 1)`
  — 0.5 at the center `(cx, cy)`, rising along the angle θ (degrees,
  screen convention: 0° → left-to-right, 90° → top-to-bottom);
- kind `Radial`:  `clip(scale·2·d, 0, 1)` with `d` the Euclidean distance
  from `(cx, cy)` — 0 at the center, 1 at `d = 0.5/scale` (invert via
  Levels/Mix for a vignette);
- kind `Box`:     `clip(scale·2·max(|u−cx|, |v−cy|), 0, 1)` — the
  Chebyshev square fade (sharp rectangular masks via a Levels threshold).

Design rules shared with Noise/Pattern/Voronoi (the sibling sources):

- **Everything dynamic rides in ARGUMENTS** (`ramp_bindings`): the
  `[cosθ, sinθ, cx, cy, scale]` f32 vector (cos/sin computed host-side in
  f64 with ONE rounding; quarter-turn angles hit an exact table so axis-
  aligned ramps are exact — the Warp convention) plus the global
  row/column index vectors and the f32 `1/W`, `1/H` reciprocals
  (f64-computed, rounded once). Angle/center/scale drags re-run one
  cached executable; only the SHAPE and the KIND (three distinct
  formulas) shape the trace.
- Per-pixel math depends ONLY on the pixel's global (row, col) coordinate
  and the arguments — no cross-pixel reductions — so the tiled
  evaluator's bands and the bucketed evaluator's padded index vectors are
  bit-transparent by construction.
- Float path: every product feeding an add routes through `nc_mul`
  (CLAUDE.md contraction rule); subs/max/abs/clip are exact ops; Radial's
  `sqrt` goes through the backend gate (`corrected_sqrt` off-CPU). No
  constant-origin planes exist (all operands derive from the index
  vectors and runtime arguments), so no const-folder guard is needed.
"""

from __future__ import annotations

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .exact_math import nc_mul

#: trace-shaping ramp kinds (serde strings, validated by NodeType.Ramp)
RAMP_KINDS = ("Linear", "Radial", "Box")

#: exact unit vectors for quarter-turn angles (f64 cos(π/2) is 6.1e-17,
#: not 0 — the table keeps axis-aligned ramps bit-exact, like ops/warp)
_QUARTER = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0),
            180.0: (-1.0, 0.0), 270.0: (0.0, -1.0)}


def ramp_bindings(payload) -> dict:
    """The canonical `ramp_<id>` program-argument pytree shared by every
    consumer: global row/column index vectors, the f32 reciprocal canvas
    extents (f64-computed, rounded once — identical bits in eager/fused/
    tiled/bucketed because numpy computes them, not XLA), and the
    `[cos, sin, cx, cy, scale]` runtime vector. The tiled evaluator
    substitutes band rows for `rows`; the bucketed evaluator pads
    `rows`/`cols` — values at true coordinates are unchanged because the
    kernel is elementwise in them."""
    width, height, _kind, angle, cx, cy, scale = payload
    d = float(angle) % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "iw": np.float32(np.float64(1.0) / np.float64(int(width))),
        "ih": np.float32(np.float64(1.0) / np.float64(int(height))),
        "k": np.asarray([cos, sin, cx, cy, scale], np.float32),
    }


def ramp_plane(kind, rows, cols, iw, ih, k):
    """Traceable gradient plane `[len(rows), len(cols)]`.

    `kind` is a STATIC Python string (one of RAMP_KINDS — three distinct
    traces); `rows`/`cols` are GLOBAL i32 pixel indices (the tiled
    evaluator passes a band's absolute rows; the bucketed evaluator
    passes padded index vectors); everything else is a traced argument.
    """
    import jax.numpy as jnp

    f32 = jnp.float32
    from .exact_math import exact_sqrt as _sqrt

    cos, sin, cx, cy, scale = k[0], k[1], k[2], k[3], k[4]
    u = nc_mul(cols.astype(f32) + f32(0.5), iw)  # [nc] in (0, 1)
    v = nc_mul(rows.astype(f32) + f32(0.5), ih)  # [nr]
    du = (u - cx)[None, :]  # [1, nc] exact sub
    dv = (v - cy)[:, None]  # [nr, 1]

    if kind == "Linear":
        proj = nc_mul(du, cos) + nc_mul(dv, sin)  # [nr, nc]
        t = f32(0.5) + nc_mul(scale, proj)
    elif kind == "Radial":
        d2 = nc_mul(du, du) + nc_mul(dv, dv)
        d = _sqrt(d2)
        t = nc_mul(scale, d + d)  # 2·d via exact add
    else:  # Box
        m = jnp.maximum(
            jnp.broadcast_to(jnp.abs(du), (dv.shape[0], du.shape[1])),
            jnp.abs(dv),
        )
        t = nc_mul(scale, m + m)
    return jnp.clip(t, f32(0.0), f32(1.0))


_jit_kernels: dict = {}


def _kernel(kind: str):
    fn = _jit_kernels.get(kind)
    if fn is None:
        import jax

        fn = jax.jit(
            lambda rows, cols, iw, ih, k, kind=kind: ramp_plane(
                kind, rows, cols, iw, ih, k
            )
        )
        _jit_kernels[kind] = fn
    return fn


def process(node):
    """Eager per-node consumer: one Gray SlotData at the payload size."""
    b = ramp_bindings(node.node_type.payload)
    kind = node.node_type.payload[2]
    out = _kernel(kind)(b["rows"], b["cols"], b["iw"], b["ih"], b["k"])
    return [SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(out)]))]
