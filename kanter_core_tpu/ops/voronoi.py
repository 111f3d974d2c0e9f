"""Voronoi node: seamlessly-tiling cellular-noise source (extension node).

No reference counterpart — the reference's only procedural source is the
1×1 Value constant (`/root/reference/src/node/value.rs:14-26`); cellular
(Worley) noise is the third classic texture source next to FBM Noise and
the Pattern lattice. One jittered feature point per lattice cell; each
pixel searches its 5×5 cell neighbourhood for the nearest two points
(exact for every jitter in [0,1] — see the window-exactness proof below).
Three Gray outputs:

- slot 0 `distance`: F1 — Euclidean distance to the nearest feature
  point, in cell units, clipped to [0, 1] (cobblestone / cell-bump field);
- slot 1 `borders`: F2 − F1, clipped to [0, 1] — exactly 0 ON the cell
  boundaries (equidistant points) rising toward each feature point;
  invert or Levels-threshold it for crack/mortar lines along the walls;
- slot 2 `cells`: the nearest point's random ID in [0, 1) — feed through
  GradientMap for per-cell tint, or Mix into roughness for per-cell wear.

Design rules shared with Noise/Pattern (the sibling source nodes):

- **Integer lattice, exact by construction**: cell indices come from
  `floor` of coordinate×frequency products; the jitter offsets and cell
  IDs come from the same lowbias32 avalanche hash Noise uses
  (`ops/noise._hash01`) keyed by the WRAPPED cell index — u32 wraparound
  arithmetic, bit-identical on every XLA backend. Salted seeds (u32 xor)
  give the three independent per-cell channels (offset-x, offset-y, ID).
- **Toroidal tiling**: candidate positions use the UNWRAPPED neighbour
  coordinate (so distances are planar) while hashes use the wrapped
  index — the sheet tiles seamlessly in both axes, matching the engine's
  wrap convention (`height_to_normal.rs:55-56`).
- **Everything dynamic rides in ARGUMENTS** (`voronoi_bindings`):
  `cells_x`/`cells_y` (f32 frequencies + i32 wrap periods), `jitter`,
  `seed`, and the global row/column index vectors — cell-count drags,
  jitter sliders, and seed cycling re-run one cached executable; only the
  SHAPE shapes the trace (no kind axis at all — simpler than Pattern).
- Per-pixel math depends ONLY on the pixel's global (row, col) coordinate
  and the arguments — no cross-pixel reductions — so the tiled
  evaluator's bands and the bucketed evaluator's padded index vectors are
  bit-transparent by construction.
- Float path: every product that feeds an add/sub routes through `nc_mul`
  (CLAUDE.md contraction rule: XLA:CPU contracts mul+add into FMAs); the
  nearest-two tracking is pure exact selects/mins with a fixed unrolled
  candidate order (strict `<` keeps the earliest candidate on ties, the
  same on every backend); `sqrt` goes through `exact_sqrt` (XLA:CPU
  sqrt is IEEE, the GPU takes `corrected_sqrt`); clips are exact min/max. The
  `best` accumulators are seeded from candidate 0 (not a ±inf constant
  plane), so no constant-origin arithmetic exists for the constant folder
  to round differently (CLAUDE.md const-guard rule) — the one `inf` init
  for F2 only ever passes through exact `minimum`/`where` lanes.
- **Window exactness (why 5×5, not 3×3)**: `jitter` is clamped to [0, 1]
  at construction, so a feature point stays inside its own cell. In cell
  units, a point in a cell at Chebyshev lattice offset k from the pixel's
  home cell is at Euclidean distance ≥ k−1, so every point outside the
  5×5 window (k ≥ 3) is at distance ≥ 2. The true F1 is at most the
  home-cell point's distance ≤ √2 < 2, and the true F2 is at most the
  larger of (a) the home point's distance and (b) the distance to the
  point of the nearer edge-adjacent cell toward the pixel's quadrant,
  whose far corner is at distance² ≤ 2 + 2t² ≤ 2.5 (t = in-cell
  coordinate ≤ ½), i.e. F2 ≤ √2.5 ≈ 1.5812 < 2. Hence the nearest TWO
  points (and the ID = argmin) always lie inside the 5×5 window and
  F1/F2/ID are exact — not approximate — cellular values for all jitter
  in [0, 1]. A 3×3 window is NOT exact above jitter ≈ 0.5 (measured
  ~1e-4 of pixels wrong at jitter=1.0, errors up to 0.13 in F2−F1 —
  round-3 advisor finding); the 25-candidate unroll stays one fused
  elementwise pass.
"""

from __future__ import annotations

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .exact_math import nc_mul
from .noise import _hash01

# u32 seed salts for the three independent per-cell hash channels
_SALT_JY = 0x68E31DA4
_SALT_ID = 0xB5297A4D

# The exact search window (module docstring proves 5×5 suffices for all
# jitter in [0,1]); shared with test_voronoi's oracles so the candidate
# ORDER — which decides ties via strict `<` — stays in lockstep.
_OFFSETS = [(dx, dy) for dy in (-2, -1, 0, 1, 2) for dx in (-2, -1, 0, 1, 2)]


def voronoi_bindings(payload) -> dict:
    """The canonical `voronoi_<id>` program-argument pytree shared by every
    consumer: global row/column index vectors, f32 cell frequencies
    (f64-computed, rounded once — identical bits in eager/fused/tiled/
    bucketed because numpy computes them, not XLA), i32 wrap periods, and
    the runtime jitter/seed scalars. The tiled evaluator substitutes band
    rows for `rows`; the bucketed evaluator pads `rows`/`cols` — values at
    true coordinates are unchanged because the kernel is elementwise in
    them."""
    width, height, cells_x, cells_y, jitter, seed = payload
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "fx": np.float32(np.float64(int(cells_x)) / np.float64(width)),
        "fy": np.float32(np.float64(int(cells_y)) / np.float64(height)),
        "px": np.int32(cells_x),
        "py": np.int32(cells_y),
        "jitter": np.float32(jitter),
        "seed": np.uint32(int(seed) & 0xFFFFFFFF),
    }


def voronoi_planes(rows, cols, fx, fy, px, py, jitter, seed):
    """Traceable `(distance, borders, cells)` planes, each
    `[len(rows), len(cols)]`.

    `rows`/`cols` are GLOBAL i32 pixel indices (the tiled evaluator passes
    a band's absolute rows; the bucketed evaluator passes padded index
    vectors); everything else is a traced argument. The 5×5 candidate loop
    is a fixed Python unroll — 25 statically-ordered select chains, no
    data-dependent control flow, so XLA fuses the whole node into one
    elementwise pass; the module docstring proves 5×5 exact for all
    jitter in [0, 1].
    """
    import jax.numpy as jnp

    f32 = jnp.float32
    u32 = jnp.uint32
    from .exact_math import exact_sqrt as _sqrt

    nr, nc = rows.shape[0], cols.shape[0]
    cy = rows.astype(f32) + f32(0.5)  # [nr] pixel centers
    cx = cols.astype(f32) + f32(0.5)  # [nc]
    u = nc_mul(cx, fx)  # [nc] lattice-space coords in [0, cells_x)
    v = nc_mul(cy, fy)  # [nr]
    xi = jnp.floor(u).astype(jnp.int32)  # [nc] home cell indices
    yi = jnp.floor(v).astype(jnp.int32)  # [nr]
    jitter = jnp.asarray(jitter, f32)
    seed = jnp.asarray(seed, u32)

    def candidate(dx, dy):
        """(d², id) for the feature point of cell (home + (dx, dy))."""
        gx = xi + jnp.int32(dx)  # [nc] unwrapped neighbour cell
        gy = yi + jnp.int32(dy)  # [nr]
        # wrapped index keys the hash (gx may be -1 → floored mod wraps)
        wx = jnp.mod(gx, px).astype(u32)[None, :]  # [1, nc]
        wy = jnp.mod(gy, py).astype(u32)[:, None]  # [nr, 1]
        jx = _hash01(jnp, wx, wy, seed)
        jy = _hash01(jnp, wx, wy, seed ^ u32(_SALT_JY))
        cid = _hash01(jnp, wx, wy, seed ^ u32(_SALT_ID))
        # point position in lattice coords: cell center + jittered offset
        ox = nc_mul(jx - f32(0.5), jitter)  # product feeds an add
        oy = nc_mul(jy - f32(0.5), jitter)
        ddx = (gx.astype(f32) + f32(0.5) - u)[None, :] + ox  # [nr, nc]
        ddy = (gy.astype(f32) + f32(0.5) - v)[:, None] + oy
        d2 = nc_mul(ddx, ddx) + nc_mul(ddy, ddy)
        return d2, cid

    # seed the accumulators from candidate 0 — no constant-plane arithmetic
    best1, best_id = candidate(*_OFFSETS[0])
    best2 = jnp.full((nr, nc), jnp.inf, f32)  # only touched by min/select
    for off in _OFFSETS[1:]:
        d2, cid = candidate(*off)
        closer = d2 < best1
        best2 = jnp.where(closer, best1, jnp.minimum(best2, d2))
        best_id = jnp.where(closer, cid, best_id)
        best1 = jnp.where(closer, d2, best1)
    f1 = _sqrt(best1)
    f2 = _sqrt(best2)
    one, zero = f32(1.0), f32(0.0)
    distance = jnp.clip(f1, zero, one)
    borders = jnp.clip(f2 - f1, zero, one)
    return distance, borders, best_id


_jit_kernel = None


def _kernel():
    global _jit_kernel
    if _jit_kernel is None:
        import jax

        _jit_kernel = jax.jit(voronoi_planes)
    return _jit_kernel


def process(node):
    """Eager per-node consumer: `distance` + `borders` + `cells` Gray
    SlotDatas at the payload size."""
    b = voronoi_bindings(node.node_type.payload)
    distance, borders, cells = _kernel()(
        b["rows"], b["cols"], b["fx"], b["fy"], b["px"], b["py"],
        b["jitter"], b["seed"],
    )
    return [
        SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(distance)])),
        SlotData(node.node_id, SlotId(1), SlotImage([plane_from_device(borders)])),
        SlotData(node.node_id, SlotId(2), SlotImage([plane_from_device(cells)])),
    ]
