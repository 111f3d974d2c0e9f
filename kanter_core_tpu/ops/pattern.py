"""Pattern node: procedural tiling-mask generator (extension node).

No reference counterpart — the reference's only procedural source is the
1×1 Value constant (`/root/reference/src/node/value.rs:14-26`); texture
authoring needs structured masks (tiles, bricks, slats) alongside Noise's
organic fields. Two Gray outputs from one cell lattice:

- slot 0 `mask`: the pattern itself — Checker parity, Stripe parity, or
  the Brick groove field — multiplied by a mortar/bevel groove ramp
  (`clip((d_edge − mortar/2) / bevel, 0, 1)`, distances in cell units;
  `bevel == 0` selects an exact hard step instead of dividing by zero);
- slot 1 `cells`: a per-cell random ID in [0, 1) — the same lowbias32
  integer-hash lattice Noise uses (`ops/noise._hash01`), keyed by the
  wrapped cell index and the seed. Feed it through GradientMap for
  per-brick tint variation, or Mix it into roughness for per-tile wear.

Design rules shared with Noise (ops/noise.py — the sibling source node):

- **Integer lattice, exact by construction**: cell indices come from
  `floor` of coordinate×frequency products; hashing is u32 wraparound
  arithmetic — bit-identical on every XLA backend.
- **Toroidal tiling**: cell indices wrap modulo `cells_x`/`cells_y`, so
  the sheet tiles seamlessly (Brick's odd-row half-cell offset wraps with
  it — running bond needs an integral `cells_x` to stay seamless, which
  the payload guarantees).
- **Everything dynamic rides in ARGUMENTS** (`pattern_bindings`):
  `cells_x`/`cells_y` (as f32 frequencies + i32 wrap periods), `mortar`,
  `bevel`, `seed`, and the global row/column index vectors — so cell
  count drags, groove edits, and seed cycling re-run one cached
  executable. Only `width`/`height` (shapes) and the pattern KIND (three
  distinct formulas) shape the trace.
- Per-pixel math depends ONLY on the pixel's global (row, col) coordinate
  and the arguments — no cross-pixel reductions — so the tiled
  evaluator's bands and the bucketed evaluator's padded index vectors are
  bit-transparent by construction.
- Float path: products feeding adds go through `nc_mul` (CLAUDE.md
  contraction rule); the one division (groove ramp, runtime divisor
  `bevel`) routes through `exact_div`, so f32 planes are bit-identical
  across backends (parity battery row `pattern_kinds`,
  `kanter_core_tpu.parity`).
"""

from __future__ import annotations

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .exact_math import nc_mul
from .noise import _hash01

#: trace-shaping pattern kinds (serde strings, mirrored by node.PatternKind)
PATTERN_KINDS = ("Checker", "Brick", "Stripe")


def pattern_bindings(payload) -> dict:
    """The canonical `pattern_<id>` program-argument pytree shared by every
    consumer: global row/column index vectors, f32 cell frequencies
    (f64-computed, rounded once — identical bits in eager/fused/tiled/
    bucketed because numpy computes them, not XLA), i32 wrap periods, and
    the runtime mortar/bevel/seed scalars. The tiled evaluator substitutes
    band rows for `rows`; the bucketed evaluator pads `rows`/`cols` —
    values at true coordinates are unchanged because the kernel is
    elementwise in them."""
    width, height, _kind, cells_x, cells_y, mortar, bevel, seed = payload
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "fx": np.float32(np.float64(int(cells_x)) / np.float64(width)),
        "fy": np.float32(np.float64(int(cells_y)) / np.float64(height)),
        "px": np.int32(cells_x),
        "py": np.int32(cells_y),
        "mortar": np.float32(mortar),
        "bevel": np.float32(bevel),
        "seed": np.uint32(int(seed) & 0xFFFFFFFF),
    }


def pattern_planes(kind, rows, cols, fx, fy, px, py, mortar, bevel, seed):
    """Traceable `(mask, cells)` planes, each `[len(rows), len(cols)]`.

    `kind` is a STATIC Python string (one of PATTERN_KINDS — three distinct
    traces); `rows`/`cols` are GLOBAL i32 pixel indices (the tiled
    evaluator passes a band's absolute rows; the bucketed evaluator passes
    padded index vectors); everything else is a traced argument.
    """
    import jax.numpy as jnp

    f32 = jnp.float32
    i32 = jnp.int32
    from .exact_math import exact_div as _div  # runtime divisors only

    nr, nc = rows.shape[0], cols.shape[0]
    cy = rows.astype(f32) + f32(0.5)  # [nr] pixel centers
    cx = cols.astype(f32) + f32(0.5)  # [nc]
    u = nc_mul(cx, fx)  # [nc] lattice-space coords in [0, cells_x)
    v = nc_mul(cy, fy)  # [nr]
    vi = jnp.floor(v)
    yi = vi.astype(i32)  # [nr] row cell index
    fv = v - vi  # exact (Sterbenz / small-magnitude)

    if kind == "Brick":
        # running bond: odd rows shift half a cell (wraps with the lattice)
        odd = jnp.bitwise_and(yi, i32(1)).astype(f32)  # [nr]
        u2 = u[None, :] + nc_mul(odd[:, None], f32(0.5))  # [nr, nc]
    else:
        u2 = jnp.broadcast_to(u[None, :], (nr, nc))
    ui = jnp.floor(u2)
    xi = ui.astype(i32)  # [nr, nc] column cell index
    fu = u2 - ui

    xw = jnp.mod(xi, px)  # wrapped cell indices (u ≥ 0, so mod is plain)
    yw = jnp.mod(yi, py)  # [nr]
    cells = _hash01(
        jnp,
        xw.astype(jnp.uint32),
        yw.astype(jnp.uint32)[:, None],
        jnp.asarray(seed, jnp.uint32),
    )

    # groove ramp: distance to the nearest cell boundary, in cell units
    du = jnp.minimum(fu, f32(1.0) - fu)  # [nr, nc]
    if kind == "Stripe":
        d = du  # stripes only break at column boundaries
    else:
        dv = jnp.minimum(fv, f32(1.0) - fv)[:, None]  # [nr, 1]
        d = jnp.minimum(du, jnp.broadcast_to(dv, du.shape))
    mortar = jnp.asarray(mortar, f32)
    bevel = jnp.asarray(bevel, f32)
    m = mortar * f32(0.5)  # exact power-of-two mul
    soft = jnp.clip(
        _div(d - m, jnp.broadcast_to(bevel, d.shape)), f32(0.0), f32(1.0)
    )
    hard = (d >= m).astype(f32)
    # bevel == 0 selects the exact step — the unselected soft lanes hold
    # ±inf/NaN from the zero divisor, dropped by the elementwise select
    groove = jnp.where(bevel > f32(0.0), soft, hard)

    if kind == "Checker":
        par = jnp.bitwise_and(xw + yw[:, None], i32(1)).astype(f32)
        mask = par * groove
    elif kind == "Stripe":
        par = jnp.bitwise_and(xw, i32(1)).astype(f32)
        mask = par * groove
    else:  # Brick: the groove field IS the mask (1 in brick, 0 in mortar)
        mask = groove
    return mask, cells


_jit_patterns: dict = {}  # kind -> jitted kernel (traces per arg shapes)


def _kernel(kind: str):
    fn = _jit_patterns.get(kind)
    if fn is None:
        import functools

        import jax

        fn = jax.jit(functools.partial(pattern_planes, kind))
        _jit_patterns[kind] = fn
    return fn


def process(node):
    """Eager per-node consumer: `mask` + `cells` Gray SlotDatas at the
    payload size."""
    b = pattern_bindings(node.node_type.payload)
    kind = node.node_type.payload[2]
    mask, cells = _kernel(kind)(
        b["rows"], b["cols"], b["fx"], b["fy"], b["px"], b["py"],
        b["mortar"], b["bevel"], b["seed"],
    )
    return [
        SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(mask)])),
        SlotData(node.node_id, SlotId(1), SlotImage([plane_from_device(cells)])),
    ]
