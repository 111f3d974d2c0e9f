"""Curvature node: gray heightmap → gray mean-curvature mask (extension
node — the reference's 13 node types have no curvature; it is the standard
companion to HeightToNormal (`/root/reference/src/node/height_to_normal.rs`)
in height-driven material authoring: convexity drives edge-wear masks,
concavity drives dirt/cavity masks).

`out = clip(0.5 + strength·lap, 0, 1)` where `lap` is the 4-neighbor
discrete Laplacian with TOROIDAL wrap (the same wrap contract as
HeightToNormal's `(x-1, y-1)` sampling, `height_to_normal.rs:55-56`, and
Blur's tap wrap): ridges (height above neighbors) go brighter than 0.5,
crevices darker. Degenerate axes (length-1) wrap to themselves, so their
terms are exactly 0.

Design follows the engine's conventions:

- `strength` is a TRACED ARGUMENT in every consumer (eager jit, fused
  compiler, tiled bands, bucketed) and is normalized out of program
  fingerprints like Value constants — a strength-slider drag re-runs one
  cached executable forever (DESIGN.md §2);
- the formulation is EXACT OPS ONLY: f32 subtract/add (single correctly
  rounded ops, never reassociated by XLA) and one `nc_mul`-guarded product
  feeding the final add (CLAUDE.md rule: XLA:CPU's LLVM would contract
  `strength*lap + 0.5` into a one-rounding FMA) — so f32 planes are
  bit-identical across backends by construction (the parity battery row
  `curvature` re-proves it per formulation, per CLAUDE.md's
  formulation-context caveat);
- banded/bucketed twins pre-gather the wrapped ±1 rows (and, bucketed,
  the wrapped ±1 columns — a roll on a padded-width plane would wrap into
  the pad) and pass them through the SAME core, preserving the exact op
  sequence — bands and pads are bit-transparent;
- gray input only (like HeightToNormal: a curvature of an RGBA image is
  ill-defined); gray output;
- NaN heights propagate (clip keeps NaN), deterministically on every
  backend;
- the Laplacian is per-PIXEL (no texel-size scale): resolution doubling
  halves the raw response, which the strength dial absorbs — documented
  rather than hidden behind a resolution heuristic.

Lowering note: like HeightToNormal, `jnp.roll` + XLA fusion is the
design — XLA fuses few-operand stencils into one streaming pass; this op is
4 rolls of one operand feeding an elementwise chain, the same class. No
Pallas kernel is warranted.
"""

from __future__ import annotations

import functools

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .common import slot_data_with_name


def curvature_plane(plane, strength, up=None, down=None, left=None,
                    right=None):
    """Traceable curvature of one `[H, W]` gray plane; `strength` is a
    traced f32 scalar. `up`/`down`/`left`/`right` are the toroidally
    wrapped ±1-shifted planes — defaulted via `jnp.roll` (the dense
    formulation); the tiled/bucketed twins pass pre-gathered bands/pads
    (the arithmetic below is identical either way, so bands and pads are
    bit-transparent)."""
    import jax.numpy as jnp

    from .exact_math import nc_mul

    def f32(p):
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        return p if p is None or p.dtype == jnp.float32 else p.astype(jnp.float32)

    plane = f32(plane)
    up, down, left, right = f32(up), f32(down), f32(left), f32(right)
    # roll on a length-1 axis is the identity (see ops/blur._blur_axis0's
    # degenerate-roll note: the shortcut also dodges XLA:CPU's compile-time
    # blowup on composed roll chains)
    if up is None:
        up = plane if plane.shape[0] == 1 else jnp.roll(plane, 1, axis=0)
    if down is None:
        down = plane if plane.shape[0] == 1 else jnp.roll(plane, -1, axis=0)
    if left is None:
        left = plane if plane.shape[1] == 1 else jnp.roll(plane, 1, axis=1)
    if right is None:
        right = plane if plane.shape[1] == 1 else jnp.roll(plane, -1, axis=1)

    # fixed association: ((h−up) + (h−down)) + ((h−left) + (h−right)).
    # f32 add/sub are exact ops; XLA never reassociates them, so every
    # consumer reproduces these bits as long as it preserves this order.
    lap = ((plane - up) + (plane - down)) + ((plane - left) + (plane - right))
    half = jnp.float32(0.5)
    return jnp.clip(half + nc_mul(strength, lap), 0.0, 1.0)


@functools.cache
def _kernel():
    import jax

    return jax.jit(lambda strength, p: curvature_plane(p, strength))


def process(slot_datas, node):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    if slot_data.image.is_rgba():
        return []  # gray only, like HeightToNormal (`height_to_normal.rs:39-43`)
    strength = np.float32(node.node_type.payload)
    out = _kernel()(strength, slot_data.image.planes[0].data())
    return [SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(out)]))]
