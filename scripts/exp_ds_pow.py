"""Verification harness for kanter_core_tpu.ops.exact_math.ds_pow.

Goal: make the GPU's `pow` match glibc powf (what the reference's Rust f32
math links against, and what XLA CPU emits) bit-for-bit on the u8-decoded
input domain, like the Dekker-corrected division in ops/mix.py. Computes
exp2(b * log2(a)) with every intermediate held as an unevaluated pair of
f32s (~49 significant bits), no FMA required.

Run on the GPU or the CPU (reference == XLA CPU pow == glibc):
    python scripts/exp_ds_pow.py        # the GPU if available
    JAX_PLATFORMS=cpu python scripts/exp_ds_pow.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from kanter_core_tpu.ops.exact_math import ds_pow  # noqa: E402

def compare(name, got, ref):
    gb, rb = got.view(np.uint32), ref.view(np.uint32)
    bad = (gb != rb) & ~(np.isnan(got) & np.isnan(ref))
    n = int(bad.sum())
    print(f"{name}: {n} mismatches of {got.size}")
    if n:
        idx = np.argwhere(bad)[:5]
        for ij in idx:
            ij = tuple(ij)
            print(f"  at {ij}: got {got[ij]!r} ref {ref[ij]!r}")
    return n


def main():
    import jax

    print("backend:", jax.default_backend())

    i = np.arange(256, dtype=np.float32) / np.float32(255.0)
    a = np.tile(i[:, None], (1, 256))
    b = np.tile(i[None, :], (256, 1))

    # reference: XLA CPU pow (== glibc powf, verified earlier on the grid)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref_grid = np.asarray(jax.jit(lambda x, y: x**y, backend="cpu")(a, b))

    got_grid = np.asarray(jax.jit(ds_pow)(a, b))
    plain_grid = np.asarray(jax.jit(lambda x, y: x**y)(a, b))
    compare("plain pow, u8 grid", plain_grid, ref_grid)
    compare("DS pow,    u8 grid", got_grid, ref_grid)

    rng = np.random.default_rng(0)
    aa = rng.random(1_000_000).astype(np.float32)  # [0,1) like texture data
    bb = rng.random(1_000_000).astype(np.float32) * 4.0
    with jax.default_device(cpu):
        ref_r = np.asarray(jax.jit(lambda x, y: x**y, backend="cpu")(aa, bb))
    got_r = np.asarray(jax.jit(ds_pow)(aa, bb))
    compare("DS pow, random [0,1)^[0,4)", got_r, ref_r)

    # wide range incl. negatives and integer exponents
    aw = (rng.standard_normal(1_000_000) * np.exp2(rng.integers(-8, 8, 1_000_000))).astype(np.float32)
    bw = np.where(
        rng.random(1_000_000) < 0.5,
        rng.integers(-4, 5, 1_000_000).astype(np.float32),
        (rng.standard_normal(1_000_000) * 2).astype(np.float32),
    )
    with jax.default_device(cpu):
        ref_w = np.asarray(jax.jit(lambda x, y: x**y, backend="cpu")(aw, bw))
    got_w = np.asarray(jax.jit(ds_pow)(aw, bw))
    compare("DS pow, wide incl. negatives", got_w, ref_w)


if __name__ == "__main__":
    main()
