"""Blur node: separable Gaussian with toroidal wrap (extension).

No reference counterpart — the reference's 13 node types have no blur, yet
it is the most-requested texture op. Design follows the engine's
conventions:

- toroidal wrap addressing like HeightToNormal (`height_to_normal.rs:55-56`
  uses the same Sampling trait), so tileable textures stay tileable;
- separable vertical-then-horizontal passes like the resampler;
- tap products through `exact_math.nc_mul` and sequential tap-order sums, so
  output planes are f32-bit deterministic across CPU and GPU (same
  discipline as `ops/resize.py`);
- weights computed host-side in f32 (radius = ceil(3σ), normalized), baked
  into the trace as constants — sigma is part of the program fingerprint.

Gray in → gray out; RGBA in → all four planes blurred.

Lowering: on the GPU the traceable kernel dispatches to the Pallas-Triton
kernel in `ops/blur_triton.py` (one read and one write per pass, no
transposes; bit-identical — its times against this module's `jnp` form
are in PERF.md). Elsewhere the `jnp` rolled-read form below runs as is.
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
from .exact_math import nc_mul

f32 = np.float32


@functools.lru_cache(maxsize=256)
def gaussian_taps(sigma: float) -> np.ndarray:
    """Normalized f32 Gaussian taps over [-radius, radius], radius=ceil(3σ)."""
    sigma = max(float(sigma), 1e-3)
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-(xs * xs) / (2.0 * sigma * sigma)).astype(np.float32)
    return (w / w.sum(dtype=np.float32)).astype(np.float32)


def _blur_axis0(plane, taps: np.ndarray):
    """Weighted sum of wrap-rolled rows, tap order preserved."""
    import jax.numpy as jnp

    radius = (len(taps) - 1) // 2
    acc = jnp.zeros_like(plane)
    # roll on a length-1 axis is the identity — short-circuit it (same
    # bits, and the degenerate roll chains otherwise hang XLA:CPU's
    # compile when composed: blur(1×1)→resample→blur measured >100 s)
    degenerate = plane.shape[0] == 1
    for t, w in enumerate(taps):
        shifted = plane if degenerate else jnp.roll(plane, radius - t, axis=0)
        acc = acc + nc_mul(shifted, jnp.float32(w))
    return acc


#: test hook: run the kernel lowering off the GPU (Pallas interpret mode)
#: so the CPU suite exercises the dispatch the GPU takes
FORCE_PALLAS_INTERPRET = False


def blur_plane(plane, sigma: float, pallas_ok: bool = True, mesh=None,
               mesh_axis=None):
    """Traceable separable wrap blur of one `[H, W]` plane (see module
    docstring for the GPU kernel dispatch; all lowerings are bit-equal).

    `mesh` (a `jax.sharding.Mesh`) selects the shard_map'd kernel: the plane
    is row-sharded over the mesh's first axis (or `mesh_axis`), and each
    shard runs the kernel on its block after a ring `ppermute` halo exchange
    (`blur_triton.blur_kernel_sharded`). GSPMD cannot partition a Pallas
    custom call, so the kernel needs that explicit form under a mesh.

    `pallas_ok=False` forces the jnp lowering — the gate for contexts no
    kernel form serves (vmapped mesh programs, GSPMD-sharded tiled bands).
    """
    import jax
    import jax.numpy as jnp

    if plane.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9: bf16 at rest, f32 in flight): the
        # compiler upcasts compute inputs before this point; a direct
        # caller's half-precision plane upcasts here so the f32 bits match
        # the default pipeline
        plane = plane.astype(jnp.float32)

    taps = gaussian_taps(round(float(sigma), 6))
    interpret = jax.default_backend() != "gpu"
    if pallas_ok and (not interpret or FORCE_PALLAS_INTERPRET):
        from . import blur_triton

        taps_tuple = tuple(float(w) for w in taps)
        if mesh is None:
            return blur_triton.blur_kernel(taps_tuple, interpret)(plane)
        axis = mesh_axis or mesh.axis_names[0]
        if blur_triton.fits_sharded(plane.shape[0], len(taps), int(mesh.shape[axis])):
            return blur_triton.blur_kernel_sharded(
                taps_tuple, mesh, axis, interpret
            )(plane)
    from jax import lax

    # barrier the operand: without it XLA:CPU duplicates the producer
    # expression into every rolled tap and its simplifier blows up on
    # composed chains (blur→resample→blur from a 1×1 Value measured >100 s
    # of compile; with the barrier 1.7 s). Runtime bits are unchanged — the
    # blur reads a materialized input either way.
    vert = _blur_axis0(lax.optimization_barrier(plane), taps)
    return _blur_axis0(vert.T, taps).T


@functools.lru_cache(maxsize=64)  # sigma edits mint new programs; bound them
def _kernel(sigma: float, planes: int, mesh=None):
    import jax

    def f(*ps):
        return tuple(blur_plane(p, sigma, mesh=mesh) for p in ps)

    return jax.jit(f)


def process(slot_datas, node, sigma: float, mesh=None):
    slot_data = slot_data_with_name(slot_datas, node, "input")
    if slot_data is None:
        return []
    planes = [p.data() for p in slot_data.image.planes]
    outs = _kernel(round(float(sigma), 6), len(planes), mesh)(*planes)
    image = SlotImage([plane_from_device(o) for o in outs])
    return [SlotData(node.node_id, SlotId(0), image)]
