"""Noise node: seamlessly-tiling value-noise / FBM source (extension node).

No reference counterpart — the reference's only procedural source is the
1×1 Value constant (`/root/reference/src/node/value.rs:14-26`); every real
texture authoring tool starts from a noise generator. Design follows the
engine's conventions:

- **Integer-lattice hashing**: each lattice corner's value comes from a
  32-bit integer mix (lowbias32-style avalanche) of `(x, y, seed)`.
  Integer multiply/xor/shift are EXACT on every XLA backend, so the
  lattice values are bit-identical across CPU/GPU/interpret by
  construction — no exact-math machinery needed for the hash itself.
- **Toroidal tiling**: lattice coordinates wrap modulo `cells·2^k` per
  octave, so the plane tiles seamlessly in both axes — matching the
  engine's wrap-stencil convention (Blur/HeightToNormal sample
  toroidally, `height_to_normal.rs:55-56`).
- **Everything dynamic rides in ARGUMENTS**: `seed`, `persistence`, the
  per-octave frequency constants and lattice periods, and the global
  row/column index vectors are all traced arguments (`noise_bindings`),
  so the trace depends only on `octaves` and the output SHAPE — seed
  cycling, persistence sliders, and `cells` edits re-run one cached
  executable (the program-cache fingerprint normalizes them out,
  `compiler._normalize_values`), and the shape-bucketed evaluator reuses
  one executable across a size drag within a bucket.
- Per-pixel math depends ONLY on the pixel's global (row, col) coordinate
  and the arguments — no cross-pixel reductions — so the tiled
  evaluator's bands and the bucketed evaluator's padded index vectors are
  bit-transparent by construction.
- The float interpolation path (quintic smootherstep + lerps + octave
  accumulation) routes every product that feeds an add/sub through
  `nc_mul` (CLAUDE.md contraction rule) and the final normalization
  through `exact_div`, so f32 planes are bit-identical across backends
  (parity battery row `noise_fbm`, `kanter_core_tpu.parity`).

Output: one Gray plane in [0, 1), height×width from the payload; consumers
resize it per their resize policy like any other producer.

Cost: the bench_ops `noise_fbm4` row (4 octaves) measures it; the 16
integer hashes + interp per pixel are elementwise ALU work with one output
write.
"""

from __future__ import annotations

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .exact_math import nc_mul

# lowbias32 avalanche constants (Chris Wellons' public-domain integer hash)
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def noise_bindings(payload) -> dict:
    """The canonical `noise_<id>` program-argument pytree shared by every
    consumer: global row/column index vectors, per-octave frequency scales
    (f64-computed, rounded once to f32 — identical bits in eager/fused/
    tiled/bucketed because numpy computes them, not XLA), lattice wrap
    periods, and the runtime seed/persistence scalars. The tiled evaluator
    substitutes band rows for `rows`; the bucketed evaluator pads
    `rows`/`cols` to bucket targets — values at true coordinates are
    unchanged because the kernel is elementwise in them."""
    width, height, cells, octaves, seed, persistence = payload
    ks = np.arange(int(octaves))
    freq = (int(cells) << ks.astype(np.int64)).astype(np.float64)
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "fx": (freq / np.float64(width)).astype(np.float32),
        "fy": (freq / np.float64(height)).astype(np.float32),
        "periods": (int(cells) << ks).astype(np.int32),
        "seed": np.uint32(int(seed) & 0xFFFFFFFF),
        "persistence": np.float32(persistence),
    }


def _hash01(jnp, x_u32, y_u32, seed_u32):
    """Per-corner lattice value in [0, 1): avalanche mix of (x, y, seed).
    All ops are u32 wrap-around arithmetic — exact on every backend."""
    u32 = jnp.uint32
    h = (
        x_u32 * u32(0x9E3779B1)
        ^ y_u32 * u32(0x85EBCA77)
        ^ seed_u32 * u32(0xC2B2AE3D)
    )
    h = h ^ (h >> u32(16))
    h = h * u32(_M1)
    h = h ^ (h >> u32(15))
    h = h * u32(_M2)
    h = h ^ (h >> u32(16))
    # top 24 bits → f32 in [0, 1): exact integer-to-float + power-of-two mul
    return (h >> u32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


def _smoother(jnp, f):
    """Quintic smootherstep f³(f(6f−15)+10); products feeding adds/subs go
    through nc_mul (contraction rule)."""
    f32 = jnp.float32
    inner = nc_mul(f, f32(6.0)) - f32(15.0)
    poly = nc_mul(f, inner) + f32(10.0)
    f3 = (f * f) * f  # products feeding a product: contraction-safe
    return f3 * poly


def noise_plane(rows, cols, seed, persistence, fx, fy, periods):
    """Traceable FBM value-noise plane `[len(rows), len(cols)]`.

    `rows`/`cols` are GLOBAL i32 pixel indices (the tiled evaluator passes a
    band's absolute rows; the bucketed evaluator passes padded index
    vectors), `seed` u32 scalar, `persistence` f32 scalar, `fx`/`fy`
    f32[octaves] per-octave frequency scales, `periods` i32[octaves]
    lattice wrap periods. Per-pixel math depends only on the pixel's global
    coordinates and the arguments, so bands/pads/crops are bit-transparent.
    """
    import jax.numpy as jnp

    f32 = jnp.float32
    octaves = fx.shape[0]
    # pixel-center coordinates (exact: int→f32 conversion + 0.5 add)
    cy = rows.astype(jnp.float32) + f32(0.5)  # [nr]
    cx = cols.astype(jnp.float32) + f32(0.5)  # [nc]

    from .exact_math import exact_div as _div  # runtime divisors only

    seed = jnp.asarray(seed, jnp.uint32)
    persistence = jnp.asarray(persistence, jnp.float32)

    acc = None
    amp = f32(1.0)
    amp_sum = f32(0.0)
    for k in range(octaves):
        u = nc_mul(cx, fx[k])  # [nc] lattice-space coords
        v = nc_mul(cy, fy[k])  # [nr]
        xi = jnp.floor(u)
        yi = jnp.floor(v)
        fu = u - xi  # exact (Sterbenz / small-magnitude)
        fv = v - yi
        period = periods[k]
        x0 = jnp.mod(xi.astype(jnp.int32), period)
        y0 = jnp.mod(yi.astype(jnp.int32), period)
        x1 = jnp.where(x0 + 1 == period, 0, x0 + 1)
        y1 = jnp.where(y0 + 1 == period, 0, y0 + 1)
        # octave-decorrelated seed (integer mix, exact)
        ks = seed + jnp.uint32(k) * jnp.uint32(0x68E31DA4)
        x0u, x1u = x0.astype(jnp.uint32)[None, :], x1.astype(jnp.uint32)[None, :]
        y0u, y1u = y0.astype(jnp.uint32)[:, None], y1.astype(jnp.uint32)[:, None]
        n00 = _hash01(jnp, x0u, y0u, ks)
        n10 = _hash01(jnp, x1u, y0u, ks)
        n01 = _hash01(jnp, x0u, y1u, ks)
        n11 = _hash01(jnp, x1u, y1u, ks)
        sx = _smoother(jnp, fu)[None, :]  # [1, nc]
        sy = _smoother(jnp, fv)[:, None]  # [nr, 1]
        nx0 = n00 + nc_mul(sx, n10 - n00)
        nx1 = n01 + nc_mul(sx, n11 - n01)
        nxy = nx0 + nc_mul(sy, nx1 - nx0)
        contrib = nc_mul(nxy, amp)
        acc = contrib if acc is None else acc + contrib
        amp_sum = amp_sum + amp
        amp = nc_mul(amp, persistence)
    return _div(acc, jnp.broadcast_to(amp_sum, acc.shape))


_jit_noise = None  # lazily-built jitted kernel (traces per arg shapes)


def _kernel():
    global _jit_noise
    if _jit_noise is None:
        import jax

        _jit_noise = jax.jit(noise_plane)
    return _jit_noise


def process(node):
    """Eager per-node consumer: one Gray SlotData at the payload size."""
    b = noise_bindings(node.node_type.payload)
    out = _kernel()(
        b["rows"], b["cols"], b["seed"], b["persistence"],
        b["fx"], b["fy"], b["periods"],
    )
    return [SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(out)]))]
