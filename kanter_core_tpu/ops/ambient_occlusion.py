"""AmbientOcclusion node: gray heightmap → gray AO mask (extension node —
the reference's 13 node types have no AO; it completes the standard
height-driven material set alongside HeightToNormal
(`/root/reference/src/node/height_to_normal.rs`) and Curvature: AO darkens
pits and crevices, the classic fourth map of an albedo/normal/roughness/AO
material).

Formulation — multi-scale blurred-height occlusion:

    occ_i = max(0, blur_sigma_i(h) - h)          for sigma_i = r, 2r, 4r
    ao    = clip(1 - (strength·w)·Σ occ_i, 0, 1)  w = 1/3, folded into the
                                                  strength SCALAR first —
                                                  see ao_combine's docstring

A point whose sigma-neighborhood average sits ABOVE it is inside a pit at
that scale and gets occluded; three octave-spaced scales capture narrow
crevices and wide basins alike. Each blur is the engine's wrap Gaussian
(`ops/blur.py`) — toroidal like HeightToNormal's `(x-1, y-1)` sampling
(`height_to_normal.rs:55-56`), so tileable heightmaps yield tileable AO,
and the dense path inherits the Pallas kernel + shard_map mesh composition
(and their measured wins) for free.

Engine conventions:

- `strength` is a TRACED ARGUMENT in every consumer and is normalized out
  of program fingerprints (a strength drag re-runs one cached executable);
  `radius` bakes the Gaussian taps into the trace like Blur's sigma — a
  radius edit refingerprints;
- exact ops only: blur taps are nc_mul-guarded sequential sums (bit
  deterministic by `ops/blur.py`'s discipline), subtract / maximum / clip
  are single correctly rounded ops, the scale weights multiply as
  host-computed f32 CONSTANTS (constant MULTIPLY is not rewritten by
  XLA:CPU — only constant DIVIDE is, CLAUDE.md), and both products feeding
  adds (`w_i * occ_i`, `strength * occ`) go through `nc_mul` so XLA:CPU's
  LLVM cannot contract them into one-rounding FMAs;
- banded/bucketed twins replay Blur's gather-formulated vertical pass per
  scale and the SAME combine core, preserving the exact op sequence — the
  device parity battery row `ambient_occlusion` (`kanter_core_tpu.parity`)
  re-proves GPU↔CPU bit parity per formulation (CLAUDE.md's
  formulation-context caveat);
- gray input only (AO of an RGBA image is ill-defined), gray output; NaN
  heights propagate deterministically;
- per-PIXEL scales like Curvature: resolution doubling halves feature
  sizes relative to the taps, which the radius dial absorbs (documented,
  not hidden behind a resolution heuristic).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import plane_from_device
from .common import slot_data_with_name

#: octave-spaced scale multipliers applied to the node's base radius
AO_SCALE_FACTORS = (1.0, 2.0, 4.0)
#: shared scale weight (host-side f32 constant; it MULTIPLIES at runtime,
#: which XLA:CPU does not rewrite — unlike constant division). The weights
#: are equal BY CONSTRUCTION: ao_combine sums the occlusions before one
#: shared multiply (see its docstring for the factoring hazard that rules
#: out per-term weights)
AO_SCALE_WEIGHTS = tuple(np.float32(1.0 / 3.0) for _ in AO_SCALE_FACTORS)


def ao_sigmas(radius: float) -> tuple:
    """The three blur sigmas for a base radius, rounded exactly like
    Blur's payload (`tiled._blur_meta` rounds to 6 decimals before the
    tap cache) so every consumer bakes identical taps."""
    return tuple(round(float(radius) * f, 6) for f in AO_SCALE_FACTORS)


def ao_taps(radius: float) -> list:
    """Gaussian tap arrays per scale (f32 constants, normalized)."""
    from .blur import gaussian_taps

    return [gaussian_taps(s) for s in ao_sigmas(radius)]


def ao_max_radius(radius: float) -> int:
    """Largest tap radius across scales — the banded twin's row halo."""
    return max((len(t) - 1) // 2 for t in ao_taps(radius))


def ao_combine(center, blurred, strength):
    """The exact elementwise combine shared by every consumer: `center` is
    the height plane, `blurred` the per-scale blur outputs at the SAME
    rows, `strength` a traced f32 scalar.

    TWO simplifier HAZARDS shaped this formulation (both instances of
    CLAUDE.md's formulation-context class, found by the parity battery and
    bisected with stage probes):

    1. the per-term form `nc_mul(occ_0,w) + nc_mul(occ_1,w) + …` with
       EQUAL weights diffed at the FIRST add — XLA's algebraic simplifier
       can FACTOR the common constant (`a·w + b·w → (a+b)·w`), one
       rounding where CPU does three. Blur never hits this because its
       tap weights are all distinct.
    2. the two-multiply chain `strength·(w·occ)` diffed — the simplifier
       can REASSOCIATE scalar multipliers into one plane multiply
       (`s·(w·occ) → (s·w)·occ`).

    The fix makes both rewrites the DEFINITION: sum the occlusions first
    (exact f32 adds in fixed order — nothing to factor), fold the shared
    weight into the strength SCALAR (one scalar·scalar rounding, identical
    on every backend), then ONE plane multiply (nc_mul: anti-FMA on CPU).
    The parity battery's `ambient_occlusion` row re-proves it per run."""
    import jax.numpy as jnp

    from .exact_math import nc_mul

    if center.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        center = center.astype(jnp.float32)
    zero = jnp.float32(0.0)
    occ = None
    for b in blurred:
        o = jnp.maximum(b - center, zero)
        occ = o if occ is None else occ + o
    st = nc_mul(strength, jnp.float32(AO_SCALE_WEIGHTS[0]))  # scalar·scalar
    one = jnp.float32(1.0)
    return jnp.clip(one - nc_mul(st, occ), 0.0, 1.0)


def ao_plane(plane, strength, radius: float, pallas_ok: bool = True,
             mesh=None, mesh_axis=None):
    """Traceable AO of one `[H, W]` gray plane (dense formulation):
    three wrap blurs via `blur_plane` (Pallas/shard_map dispatch and all
    — every lowering is bit-equal by Blur's contract), then the shared
    combine. `strength` is a traced f32 scalar; `radius` is static."""
    import jax.numpy as jnp

    from .blur import blur_plane

    if plane.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9): compute in f32, fresh per consumer
        plane = plane.astype(jnp.float32)
    # NOTE: the three blurs share one operand and fuse freely with the
    # combine — every blur output stays bit-equal to the standalone kernel
    # in this composition; the two rewrites that DID drift lived in the
    # combine (see ao_combine's docstring for the hazards and the fix).
    blurred = [
        blur_plane(plane, s, pallas_ok=pallas_ok, mesh=mesh,
                   mesh_axis=mesh_axis)
        for s in ao_sigmas(radius)
    ]
    return ao_combine(plane, blurred, strength)


@functools.lru_cache(maxsize=64)  # radius edits mint new programs; bound them
def _kernel(radius: float, mesh=None):
    import jax

    return jax.jit(lambda strength, p: ao_plane(p, strength, radius, mesh=mesh))


def process(slot_datas, node, mesh=None):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    if slot_data.image.is_rgba():
        return []  # gray only, like HeightToNormal (`height_to_normal.rs:39-43`)
    strength, radius = node.node_type.payload
    out = _kernel(float(radius), mesh)(
        np.float32(strength), slot_data.image.planes[0].data()
    )
    return [SlotData(node.node_id, SlotId(0), SlotImage([plane_from_device(out)]))]
