"""Warp node: directional displacement by a gray strength map (extension
node, 19th type).

No reference counterpart — the reference's spatial ops stop at resize
policies and wrap stencils (`/root/reference/src/node/mod.rs:100-130`,
`height_to_normal.rs:55-56`); a directional warp driven by a mask is the
other staple placement op of texture authoring tools. The design reuses the
Transform node's parity-verified machinery wholesale:

- **Semantics**: output pixel `(x, y)` bilinearly samples the input (with
  toroidal wrap, the engine's stencil convention) at
  `(x + kx·(m−0.5), y + ky·(m−0.5))` where `m` is the strength map's value
  at `(x, y)` CLAMPED to the unit interval (NaN ⇒ 0.5, i.e. identity) and
  `(kx, ky) = intensity · (cos θ, sin θ)` for `angle` θ in degrees. Angle 0
  displaces along +x (right); 90 along +y (down — rows grow downward). A
  strength of 0.5 is zero displacement, so mid-gray maps are identity; both
  parameters ride as ONE f32[2] program argument (`warp_bindings`,
  host-computed f64→f32 with the quarter-turn exact table), so drags re-run
  cached executables.
- **Strength is a unit-interval map BY DEFINITION**: the clamp is not a
  numerical guard but the node's contract — it bounds the displacement by
  `intensity/2` pixels, which is what makes the op *local*: the tiled twin
  hoists only `±warp_halo` input rows per band (instead of the full
  height), and mesh programs run a `shard_map` with a one-hop ring
  `ppermute` halo exchange (instead of GSPMD all-gathering every input
  plane). `warp_halo` buckets the bound to a power of two and the program
  fingerprint keeps the bucket (`compiler._normalize_values`), so
  intensity drags only retrace when they cross a bucket boundary.
- **Missing strength input ⇒ pass-through alias**: with slot 1 dangling the
  node forwards its input planes untouched (an aliasing op, like Output —
  no kernel, no bf16 cast), which is also what the formula degenerates to.
  A missing slot-0 input raises INVALID_BUFFER_COUNT like Transform.
- **Bit parity across consumers**: the coordinate math is two nc_mul
  products added to exact pixel centers, then the shared
  `transform.bilinear_wrap_gather` formulation (clip→floor→mod→gather→
  fixed-association lerp), with the wrap extents barriered for the same
  constant-folder reason as Transform. The strength plane reaches the
  kernel ALIGNED to the output grid in every consumer: the tiled twin
  row-gathers the band's rows out of the hoisted full-height map BEFORE
  the elementwise coordinate math (gathers commute bit-exactly with
  elementwise ops), the bucketed twin uses its padded plane positionally.
  Parity battery row: `warp_directional`.
- **Tiled cost**: like Transform, any output row may sample any input row
  (the map is unbounded data), so `_expand_rows` hoists the FULL input
  height — bands are correct but ancestor-dense on this node's inputs.

Output: same plane count and size as the input.
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
from .transform import _QUARTER, bilinear_wrap_gather


def warp_bindings(payload) -> dict:
    """The canonical `warp_<id>` program argument: `k = intensity·(cos θ,
    sin θ)` as one f32[2], host-computed in f64 with a single rounding
    (quarter-turn angles hit the exact table so axis-aligned warps move by
    exactly `intensity·(m−0.5)` pixels)."""
    deg, intensity = (float(v) for v in payload)
    d = deg % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    k = np.float64(intensity) * np.asarray([cos, sin], np.float64)
    return {"k": k.astype(np.float32)}


def warp_planes(planes, strength, rows, cols, k, wrap_h, wrap_w,
                row_local=None):
    """Traceable directional warp of `planes` (each `[Hp, Wp]`, logical
    extent `(wrap_h, wrap_w)`) at output pixels `rows × cols` (GLOBAL i32
    index vectors). `strength` is the gray map ALIGNED to the output grid
    (`[len(rows), len(cols)]` — callers gather/crop it first). `k` is the
    f32[2] displacement vector from `warp_bindings`; `wrap_h`/`wrap_w` are
    trace-time ints OR runtime i32 scalars (bucketed). `row_local` remaps
    global row indices into `planes` when they hold a row subset (see
    `bilinear_wrap_gather`). XLA lowers the four bilinear taps to native
    gathers on every backend."""
    import jax.numpy as jnp
    from jax import lax

    f32 = jnp.float32
    # barrier the wrap extents — same constant-folder hazard as Transform
    wh = lax.optimization_barrier(jnp.asarray(wrap_h, jnp.int32))
    ww = lax.optimization_barrier(jnp.asarray(wrap_w, jnp.int32))
    m = strength
    if m.dtype != f32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        m = m.astype(f32)
    # the unit-interval contract (module docstring): clamp, NaN ⇒ identity.
    # clip/select are exact, and for in-range maps they pass values through
    # untouched — every pre-existing in-range result keeps its bits.
    ms = jnp.clip(m, f32(0.0), f32(1.0))
    ms = jnp.where(m != m, f32(0.5), ms)
    d = ms - f32(0.5)  # [nr, nc]; exact for m in [0.25, 1] (Sterbenz)
    u = cols.astype(f32)[None, :] + nc_mul(k[0], d)  # continuous texel coord
    v = rows.astype(f32)[:, None] + nc_mul(k[1], d)
    return bilinear_wrap_gather(planes, u, v, wh, ww, row_local=row_local)


def warp_halo(intensity):
    """Static row-halo bound baked into traces that exploit the bounded
    displacement (tiled band row sets, the mesh shard_map): clamped
    strength gives `|dy| ≤ |intensity|/2`, +1 for the bilinear row pair,
    +1 for f32 coordinate slop, rounded up to a power of two (≥4) so
    intensity drags rarely cross buckets — the program fingerprint keeps
    the bucket (`compiler._normalize_values`), so crossing one retraces
    exactly once per bucket. Returns None for a non-finite intensity
    (unbounded ⇒ callers hoist the full height / skip the shard path)."""
    import math

    intensity = float(intensity)
    if not math.isfinite(intensity):
        return None
    need = math.ceil(abs(intensity) * 0.5) + 2
    return max(4, 1 << (need - 1).bit_length())


def fits_mesh(h: int, n: int, halo) -> bool:
    """Viability of the shard_map'd warp: a bounded halo, ≥2 shards, rows
    divide the mesh axis, each block covers the halo in ONE ring hop, and
    the halo-extended block is unambiguous (`block + 2·halo ≤ h` keeps the
    global→local row remap injective over the window)."""
    return (
        halo is not None
        and n >= 2
        and h % n == 0
        and h // n >= halo
        and h // n + 2 * halo <= h
    )


def warp_planes_mesh(planes, strength, k, mesh, axis, halo, h, w):
    """shard_map'd warp: planes and strength row-sharded over `axis`; each
    device ring-`ppermute`s the ±`halo` boundary rows of its block (the
    ring neighbors ARE the toroidal continuation) and samples shard-locally
    through the same `warp_planes` formulation with a global→local row
    remap. Without this, GSPMD all-gathers every input plane of every Warp
    in a mesh program — the displacement bound makes `2·halo·W` f32 rows per
    device the true interconnect cost. Gathered texels and lerp bits are
    identical to the dense lowering (`test_mesh_engine` pins sharded ==
    dense bit-for-bit)."""
    import jax.numpy as jnp
    from jax import lax, shard_map
    from jax.sharding import PartitionSpec as P

    n = int(mesh.shape[axis])
    block = h // n
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]

    def body(planes_blk, m_blk, kk):
        start = (lax.axis_index(axis) * block).astype(jnp.int32)
        rows = start + jnp.arange(block, dtype=jnp.int32)
        ext = []
        for p in planes_blk:
            # device j receives shard j-1's bottom rows (its preceding rows)
            top = lax.ppermute(p[-halo:], axis, fwd)
            # … and shard j+1's top rows (its following rows)
            bot = lax.ppermute(p[:halo], axis, bwd)
            ext.append(jnp.concatenate([top, p, bot], axis=0))

        def row_local(y):
            # window rows [start-halo, start+block+halo) mod h → [0, …);
            # injective because fits_mesh pinned block + 2·halo ≤ h
            return jnp.mod(y - start + jnp.int32(halo), jnp.int32(h))

        return warp_planes(
            tuple(ext), m_blk, rows, jnp.arange(w, dtype=jnp.int32),
            kk, h, w, row_local=row_local,
        )

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P()),
        out_specs=P(axis, None),
    )(tuple(planes), strength, k)


@functools.cache
def _kernel():
    import jax

    return jax.jit(warp_planes, static_argnums=(5, 6))


@functools.lru_cache(maxsize=16)
def _mesh_kernel(mesh, axis, halo, h, w):
    import jax

    def f(planes, strength, k):
        return warp_planes_mesh(planes, strength, k, mesh, axis, halo, h, w)

    return jax.jit(f)


def process(slot_datas, node, mesh=None):
    """Eager per-node consumer: same plane count and size as the input;
    dangling strength input aliases the input planes through. `mesh`
    selects the shard_map'd halo-exchange kernel when the geometry fits
    (the auto_update path's mesh story, like `blur.process`)."""
    from ..errors import ErrorKind, TexProError

    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        raise TexProError(ErrorKind.INVALID_BUFFER_COUNT, "Warp needs an input")
    strength = slot_data_with_name(slot_datas, node, "strength")
    if strength is None:
        # pass-through alias (zero displacement): the image is shared, not
        # copied — the same re-key Output does (`output.rs:12-33`)
        return [SlotData(node.node_id, SlotId(0), slot_data.image)]
    b = warp_bindings(node.node_type.payload)
    planes = [p.data() for p in slot_data.image.planes]
    h, w = planes[0].shape
    if mesh is not None:
        axis = mesh.axis_names[0]
        halo = warp_halo(node.node_type.payload[1])
        if fits_mesh(h, int(mesh.shape[axis]), halo):
            outs = _mesh_kernel(mesh, axis, halo, h, w)(
                tuple(planes), strength.image.planes[0].data(), b["k"]
            )
            image = SlotImage([plane_from_device(o) for o in outs])
            return [SlotData(node.node_id, SlotId(0), image)]
    outs = _kernel()(
        tuple(planes),
        strength.image.planes[0].data(),
        np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32),
        b["k"], h, w,
    )
    image = SlotImage([plane_from_device(o) for o in outs])
    return [SlotData(node.node_id, SlotId(0), image)]
