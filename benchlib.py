"""Shared measurement scaffolding for bench.py / bench_ops.py.

Every measurement (see bench.py's module docstring):

1. runs N evaluations inside ONE jitted `lax.scan`, each iteration binding a
   unique scalar and emitting an on-device checksum behind an
   `lax.optimization_barrier` (forces full materialization);
2. fetches all N checksums to host inside the timed window and verifies they
   are pairwise distinct;
3. times the scan at two lengths N1 < N2 and reports
   `(T(N2)-T(N1))/(N2-N1)` — fixed dispatch overhead cancels.
"""

from __future__ import annotations

import time

import numpy as np


def device_random(shape, seed: int):
    """Random f32 planes generated ON DEVICE — shipping gigabytes of random
    inputs from the host would dominate the benchmark's wall clock without
    touching what is being measured."""
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda k: jax.random.uniform(k, shape, dtype=jnp.float32))
    out = fn(jax.random.PRNGKey(seed))
    jax.block_until_ready(out)
    return out


def chk(planes):
    """On-device checksum forcing full materialization: the barrier pins the
    planes as real buffers, then a tiny corner slice + center pixel reduces
    them to one scalar per iteration."""
    import jax.numpy as jnp
    from jax import lax

    planes = lax.optimization_barrier(planes)
    total = jnp.float32(0)
    for p in planes:
        if jnp.issubdtype(p.dtype, jnp.integer):
            # integer planes (u32 packs): accumulate EXACTLY with wrapping
            # u32 arithmetic and round only once at the end — summing
            # full-range u32 values in f32 absorbs small deltas below the
            # accumulator's ulp (~1e6 at 1e13), which silently collided
            # checksums of genuinely distinct outputs
            q = p.astype(jnp.uint32)
            h, w = q.shape[-2], q.shape[-1]
            wrapped = jnp.sum(
                q[..., : min(64, h), : min(64, w)], dtype=jnp.uint32
            ) + jnp.sum(q[..., h // 2, w // 2], dtype=jnp.uint32) * jnp.uint32(1024)
            # mask below 2^24 so the f32 cast is EXACT (an unmasked wrap
            # lands anywhere in [0, 2^32) where the cast rounds to ulp up
            # to 512 — r8-sized deltas then sit a few ulp apart and can
            # still collide); deltas survive exactly mod 2^20
            total = total + (wrapped & jnp.uint32(0xFFFFF)).astype(jnp.float32)
            continue
        p = p.astype(jnp.float32) if p.dtype != jnp.float32 else p
        h, w = p.shape[-2], p.shape[-1]
        total = total + jnp.sum(p[..., : min(64, h), : min(64, w)])
        total = total + jnp.sum(p[..., h // 2, w // 2]) * 1024.0
    return total


class ScanBench:
    """Times `body(val, consts) -> planes` amortized over a jitted lax.scan.

    `consts` (the big input planes) are explicit jit arguments — closing over
    device arrays would bake them into the compiled program as constants."""

    def __init__(
        self, body, consts, n1: int, n2: int, base: float = 1.0, step: float = 1e-4
    ):
        import jax
        from jax import lax

        def scan_fn(vals, consts):
            def step(carry, val):
                return carry, chk(body(val, consts))

            _, checks = lax.scan(step, 0, vals)
            return checks

        self._jit = jax.jit(scan_fn)
        self._consts = consts
        self._base = base
        self._step = step
        self.n1, self.n2 = n1, n2

    def _time(self, n: int, seed: int) -> tuple[float, np.ndarray]:
        vals = (
            self._base
            + np.arange(n, dtype=np.float32) * self._step
            + seed * self._step / 10.0
        )
        t0 = time.perf_counter()
        # forcing read of all N checksums
        checks = np.asarray(self._jit(vals, self._consts))
        return time.perf_counter() - t0, checks

    def run(self, repeats: int = 5) -> tuple[float, bool]:
        """Returns (seconds per evaluation, checksums_distinct)."""
        # warm both compiles
        self._time(self.n1, 99)
        self._time(self.n2, 99)
        distinct = True
        per_iter = []
        for r in range(repeats):
            t1, c1 = self._time(self.n1, r)
            t2, c2 = self._time(self.n2, r)
            distinct &= len(set(c1.tolist())) == len(c1)
            distinct &= len(set(c2.tolist())) == len(c2)
            per_iter.append((t2 - t1) / (self.n2 - self.n1))
        # host stalls are one-sided noise but can hit either T(n1) or
        # T(n2); the median of the differences is the robust estimator
        return max(float(np.median(per_iter)), 1e-9), distinct
