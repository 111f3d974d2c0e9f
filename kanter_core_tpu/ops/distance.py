"""Distance node: gray seed mask → gray normalized distance fade
(extension node — the reference's 13 node types have no distance field;
it is the classic mask-spread op of texture authoring: mortar spread,
rust creep from cracks, gradient aprons around pattern cells).

Semantics: pixels where `mask > 0.5` are SEEDS. Every pixel gets the
TOROIDAL distance `d` to its nearest seed (wrap addressing like
HeightToNormal's `(x-1, y-1)` sampling, `height_to_normal.rs:55-56`, so
tileable masks yield tileable fields), and the output is the fade

    out = clip(1 − d / max_dist, 0, 1)

— 1.0 on seeds, falling linearly to 0 at `max_dist` pixels. A seedless
mask produces all-zero output (the sentinel distance saturates the fade).

Algorithm — Jump Flooding (JFA), the GPU-classic O(N log N) nearest-seed
propagation: ceil(log2(max(H, W)))+1
step-batched passes, each folding eight rolls of ONE packed i32
nearest-seed plane through a fixed-order select chain. Every pass is
data-independent elementwise compare+select over rolled copies — no
data-dependent control flow, and the pass count is static in the trace
(Python loop: shapes are static per program, matching the engine's
size-keyed fingerprints). XLA fuses each step's eight rolls and select
chain into one loop fusion; per-step time at 4096² is in PERF.md.

Determinism design (CLAUDE.md discipline):

- the ENTIRE propagation is INTEGER: seed coordinates ride as i32 planes,
  toroidal deltas and squared distances are i32 adds/mults — exact on
  every backend by construction; ties resolve by strict `<` compare in a
  fixed offset order (first-seen wins), which is deterministic because
  the candidate order is static;
- JFA is an approximation in adversarial layouts (a pixel can miss its
  true nearest seed when closer seeds "shadow" it mid-pass) but a
  DETERMINISTIC one: the same mask gives the same field on every backend,
  which is the engine contract; the approximation error is bounded and
  rare (<0.3% of pixels off by a small factor in the literature), and the
  fuzz/battery rows assert bit parity, not Euclidean optimality;
- the only f32 ops are the final `sqrt` (`exact_sqrt`: the GPU's sqrt is
  ~1 ulp loose), the division by the runtime `max_dist` argument
  (`exact_div`; never a constant divisor — XLA rewrites those, CLAUDE.md),
  the subtract, and the clip — all single correctly rounded ops given
  identical inputs;
- i32→f32 conversion of the squared distance is correctly rounded on
  every backend (values ≤ (W/2)²+(H/2)² stay well inside i32).

`max_dist` is a TRACED ARGUMENT (`dist_<id>`) — a spread drag re-runs one
cached executable; the threshold is fixed at 0.5 (mask authorship owns
the cut, like Pattern's bevel owns its ramp).

Consumers: the op is GLOBAL (any pixel may be nearest to any seed), so
the tiled twin hoists the full input height per band like Transform
(documented band-dense cost) and the bucketed gate excludes it (a padded
plane cannot wrap-roll; partitions containing Distance fall back to the
dense fused path, asserted by tests). Because banding cannot bound the
hoisted full-height input, a partition whose band-dense floor exceeds
DEVICE capacity (the engine's auto half-of-HBM budget — an explicit
tiny `tile_bytes`, the test idiom for forcing banding, still bands) is
REFUSED with a diagnosable RESOURCE_EXHAUSTED graph-fatal error
(`tiled.band_dense_floor_bytes` + the engine gate;
`tests/test_tiled.py::test_band_dense_distance_capacity_gate`) — the
explicit degradation analog of `transient_buffer.rs:388-406`.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .common import slot_data_with_name

#: squared-distance sentinel for "no seed found yet" — larger than any
#: toroidal d² (W,H ≤ 30k ⇒ d² ≤ 2·15000² < 2³⁰) and addition-safe
_FAR = np.int32(2**30)


def _jfa_steps(h: int, w: int) -> list:
    """Power-of-two step ladder: max(H,W)/2 … 1 (classic JFA), plus a
    final 1-step "JFA+1" refinement pass that removes most of the
    vanilla algorithm's rare misses at one extra sweep's cost."""
    n = max(h, w)
    if n <= 1:
        return [1]
    steps = [2 ** p for p in range(int(math.ceil(math.log2(n))) - 1, -1, -1)]
    return steps + [1]


def distance_plane(mask, max_dist):
    """Traceable normalized-distance fade of one `[H, W]` gray plane;
    `max_dist` is a traced f32 scalar (pixels). See module docstring.
    Under a mesh the rolls lower to collective permutes."""
    import jax.numpy as jnp

    from .exact_math import exact_div, exact_sqrt

    from jax import lax

    h, w = mask.shape
    if mask.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        mask = mask.astype(jnp.float32)
    # barrier the operand: the first JFA pass rolls the seed planes eight
    # ways, and XLA:CPU's simplifier duplicates producers into every
    # rolled tap of a composed chain (the blur's measured >100 s compile
    # class — ops/blur.py). Runtime bits are unchanged.
    mask = lax.optimization_barrier(mask)

    rows = jnp.arange(h, dtype=jnp.int32)[:, None] * jnp.ones((1, w), jnp.int32)
    cols = jnp.ones((h, 1), jnp.int32) * jnp.arange(w, dtype=jnp.int32)[None, :]
    seed = mask > jnp.float32(0.5)
    far = jnp.int32(_FAR)

    # PACKED single-plane state: the nearest-seed coordinate rides as
    # y<<16 | x in ONE i32 plane instead of (best_y, best_x, best_d2)
    # three, so each step moves a third of the bytes (bit-identical by
    # integer exactness), and the d²
    # values are recomputed from the packed coords inside the fused pass
    # (pure i32 ops, exact on every backend; d² is a function of the
    # stored coords, so recompute == carry). Coords are in-range by
    # construction (rolls permute
    # positions; values never leave [0,h)×[0,w)), the pack is lossless for
    # h ≤ 32767 and w ≤ 65535 (beyond the documented 30k canvas bound),
    # and the sentinel 0x7FFFFFFF exceeds every real pack. Candidate
    # order, strict-< tie-breaks, and all d² values are unchanged from the
    # unpacked formulation — the bitwise numpy oracle
    # (`tests/test_distance.py::_oracle`) still mirrors an UNPACKED pass
    # order and the outputs match bit for bit.
    if h > 32767 or w > 65535:
        # NOT an assert: `python -O` strips asserts, and a taller canvas
        # would silently overflow the y<<16 pack into the sign bit —
        # surface a diagnosable graph error instead (commit-time handling
        # mirrors the reference's kernel-error path, engine.rs:104-120)
        from ..errors import ErrorKind, TexProError

        raise TexProError(
            ErrorKind.GENERIC,
            f"Distance canvas {w}x{h} exceeds the packed-JFA bound "
            "(h <= 32767, w <= 65535)",
        )
    sent = jnp.int32(0x7FFFFFFF)
    pix = (rows << jnp.int32(16)) | cols
    packed = jnp.where(seed, pix, sent)

    half_h, half_w = jnp.int32(h // 2), jnp.int32(w // 2)
    hh, ww = jnp.int32(h), jnp.int32(w)

    def d2_of(cand):
        # toroidal |Δ| per axis (i32-exact); the sentinel saturates
        valid = cand != sent
        cy = jnp.right_shift(cand, jnp.int32(16))
        cx = jnp.bitwise_and(cand, jnp.int32(0xFFFF))
        dy = jnp.abs(rows - cy)
        dy = jnp.where(dy > half_h, hh - dy, dy)
        dx = jnp.abs(cols - cx)
        dx = jnp.where(dx > half_w, ww - dx, dx)
        dy = jnp.where(valid, dy, jnp.int32(0))
        dx = jnp.where(valid, dx, jnp.int32(0))
        return jnp.where(valid, dy * dy + dx * dx, far)

    # STEP-BATCHED update (textbook JFA): all eight candidates of a step
    # are rolls of the STEP-START state, folded through a fixed-order
    # strict-< select chain; the state writes once per STEP, not once per
    # offset (a sequential-propagation variant, each offset rolling the
    # just-updated state, forced a materialization per OFFSET). Both
    # variants measured EXACT vs the f64 brute-force toroidal EDT on
    # random masks at two seed densities (the JFA+1 ladder removes the
    # textbook misses).
    for k in _jfa_steps(h, w):
        best = packed
        best_d2 = d2_of(packed)
        for oy in (-k, 0, k):
            for ox in (-k, 0, k):
                if oy == 0 and ox == 0:
                    continue
                # toroidal roll; degenerate/oversized axes wrap self
                cand = packed
                if h > 1 and oy % h != 0:
                    cand = jnp.roll(cand, oy, axis=0)
                if w > 1 and ox % w != 0:
                    cand = jnp.roll(cand, ox, axis=1)
                d2 = d2_of(cand)
                better = d2 < best_d2  # strict: first-seen wins ties
                best = jnp.where(better, cand, best)
                best_d2 = jnp.where(better, d2, best_d2)
        packed = best

    dist = exact_sqrt(d2_of(packed).astype(jnp.float32))
    one = jnp.float32(1.0)
    fade = one - exact_div(dist, jnp.maximum(max_dist, jnp.float32(1e-6)))
    return jnp.clip(fade, 0.0, 1.0)


@functools.cache
def _kernel():
    import jax

    return jax.jit(lambda max_dist, p: distance_plane(p, max_dist))


def process(slot_datas, node, mesh=None):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    if slot_data.image.is_rgba():
        return []  # gray only: a distance field of an RGBA image is ill-defined
    max_dist = np.float32(node.node_type.payload)
    # mesh: inputs arrive GSPMD-row-sharded (`ops._shard_inputs`)
    out = _kernel()(
        max_dist, slot_data.image.planes[0].data()
    )
    return [SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(out)]))]
