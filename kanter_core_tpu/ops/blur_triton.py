"""Separable wrap blur as two Pallas kernels through Triton (GPU).

Each pass is one kernel over `[BR, BC]` output blocks. A block reads its
taps straight from the source plane at wrapped row (vertical pass) or
column (horizontal pass) offsets, so neighbouring taps hit the L1/L2 copies
of the same lines, and writes its block once. Against the `jnp` form
(`blur._blur_axis0` twice around two transposes) this drops both transposes
and every rolled copy XLA materializes. Times against that form on the H100
are in PERF.md ("Kernels on the H100").

Bits: every output is `acc = 0; acc = acc + nc_mul(x[tap], w[tap])` in the
`jnp` form's tap order, so the result equals the `jnp` lowering bit for bit
(`nc_mul` reads the backend's `exact_math.numerics()` row at trace time,
exactly as the `jnp` form does). The backward pass is the `jnp` form's, and
under a mesh each shard runs the kernel on its rows after a ring
`ppermute` of the ±radius halo rows.
"""

from __future__ import annotations

import functools

#: output block of one program instance: rows × columns (powers of two)
BLOCK = (32, 128)


def _pass_kernel(x_ref, o_ref, *, taps, axis, h, w, halo, block):
    """One pass over output block (i, j) of an `[h, w]` result. Axis 0 reads
    rows `(r + t − radius) mod h`, or rows `r + t` of a source that carries
    its ±radius halo rows (`halo=True`); axis 1 reads wrapped columns."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from .exact_math import nc_mul

    br, bc = block
    rows = pl.program_id(0) * br + jnp.arange(br, dtype=jnp.int32)
    cols = pl.program_id(1) * bc + jnp.arange(bc, dtype=jnp.int32)
    mask = (rows < h)[:, None] & (cols < w)[None, :]
    radius = (len(taps) - 1) // 2
    n = h if axis == 0 else w
    base = rows if axis == 0 else cols
    acc = jnp.zeros(block, jnp.float32)
    for t, wt in enumerate(taps):
        if halo:
            src = base + jnp.int32(t)
        else:
            # (t − radius) mod n ∈ [0, n): one subtraction wraps every live
            # lane, the second only lanes the mask drops anyway
            src = base + jnp.int32((t - radius) % n)
            src = jnp.where(src >= n, src - n, src)
            src = jnp.where(src >= n, src - n, src)
        idx = (src[:, None], cols[None, :]) if axis == 0 else (rows[:, None], src[None, :])
        v = plgpu.load(x_ref.at[idx], mask=mask, other=0.0)
        acc = acc + nc_mul(v, jnp.float32(wt))
    plgpu.store(o_ref.at[rows[:, None], cols[None, :]], acc, mask=mask)


@functools.lru_cache(maxsize=128)
def _pass_call(h: int, w: int, taps: tuple, axis: int, halo: bool,
               block: tuple, interpret: bool):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    kernel = functools.partial(
        _pass_kernel, taps=taps, axis=axis, h=h, w=w, halo=halo, block=block
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
        grid=(pl.cdiv(h, block[0]), pl.cdiv(w, block[1])),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=f"blur_pass{axis}",
    )


def blur_triton(plane, taps: tuple, block: tuple = BLOCK, interpret: bool = False):
    """Vertical then horizontal wrap blur of one f32 `[H, W]` plane."""
    h, w = plane.shape
    vert = _pass_call(h, w, taps, 0, False, block, interpret)(plane)
    return _pass_call(h, w, taps, 1, False, block, interpret)(vert)


def blur_rows_with_halo(ext, taps: tuple, interpret: bool = False):
    """Blur of the interior rows of `ext` = [radius halo rows; block;
    radius halo rows]: rows come from the halo (no row wrap), columns wrap."""
    radius = (len(taps) - 1) // 2
    h, w = ext.shape[0] - 2 * radius, ext.shape[1]
    vert = _pass_call(h, w, taps, 0, True, BLOCK, interpret)(ext)
    return _pass_call(h, w, taps, 1, False, BLOCK, interpret)(vert)


def _with_jnp_backward(fn, taps: tuple):
    """`fn` with the `jnp` form's VJP (the same linear map, bit for bit)."""
    import jax
    import numpy as np

    from .blur import _blur_axis0

    taps_arr = np.asarray(taps, dtype=np.float32)

    def jnp_blur(q):
        return _blur_axis0(_blur_axis0(q, taps_arr).T, taps_arr).T

    @jax.custom_vjp
    def blur_fn(p):
        return fn(p)

    def fwd(p):
        return fn(p), p

    def bwd(p, cotangent):
        return jax.vjp(jnp_blur, p)[1](cotangent)

    blur_fn.defvjp(fwd, bwd)
    return blur_fn


@functools.lru_cache(maxsize=64)  # sigma edits mint new programs; bound them
def blur_kernel(taps: tuple, interpret: bool = False):
    """Differentiable, vmappable single-device kernel blur."""
    return _with_jnp_backward(
        lambda p: blur_triton(p, taps, interpret=interpret), taps
    )


def fits_sharded(height: int, taps_len: int, n_shards: int) -> bool:
    """The sharded kernel needs rows that divide the mesh axis and shard
    blocks that cover the halo in one ring hop."""
    radius = (taps_len - 1) // 2
    return height % n_shards == 0 and height // n_shards >= radius


@functools.lru_cache(maxsize=32)
def blur_kernel_sharded(taps: tuple, mesh, axis, interpret: bool = False):
    """shard_map'd kernel: each device runs the kernel on its row block
    after a ring `ppermute` of the ±radius halo rows (the ring neighbours
    ARE the toroidal continuation, so global wrap falls out of the
    exchange; `height_to_normal.rs:55-56`'s sampling at mesh scale)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n = int(mesh.shape[axis])
    radius = (len(taps) - 1) // 2

    def body(block):
        if n == 1:
            top, bot = block[-radius:], block[:radius]
        else:
            # device j receives shard j-1's bottom rows (its preceding rows)
            top = jax.lax.ppermute(block[-radius:], axis, [(i, (i + 1) % n) for i in range(n)])
            # … and shard j+1's top rows (its following rows)
            bot = jax.lax.ppermute(block[:radius], axis, [(i, (i - 1) % n) for i in range(n)])
        ext = jnp.concatenate([top, block, bot], axis=0)
        return blur_rows_with_halo(ext, taps, interpret=interpret)

    # check_vma=False: pallas_call can't declare its output's varying-axes
    # set, so shard_map's replication checker must be off (the body is
    # honestly varying over `axis` and nothing else)
    sharded = shard_map(
        body, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
        check_vma=False,
    )
    return _with_jnp_backward(sharded, taps)
