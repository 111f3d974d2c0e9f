"""Tests that need the GPU: the compiled Pallas-Triton blur kernel and the
measured numerics row. They skip here (no card) and run on the card inside
`chip_smoke.py`'s process (`pytest -m gpu`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanter_core_tpu.ops.blur import _blur_axis0, blur_plane, gaussian_taps

pytestmark = pytest.mark.gpu


def _jnp_blur(p, sigma):
    taps = gaussian_taps(round(float(sigma), 6))
    return _blur_axis0(_blur_axis0(p, taps).T, taps).T


def test_numerics_row_matches_probe(gpu):
    from kanter_core_tpu.ops.exact_math import numerics
    from kanter_core_tpu.parity import probe_numerics

    assert probe_numerics() == numerics(gpu.platform)


@pytest.mark.parametrize("h,w,sigma", [
    (173, 211, 2.2),   # no dimension a block multiple
    (48, 128, 8.0),    # radius 24 ≈ half the height: the halo wraps
    (5, 7, 3.0),       # radius > both extents
    (1024, 768, 5.0),
])
def test_compiled_blur_kernel_matches_jnp(gpu, h, w, sigma):
    from kanter_core_tpu.ops.blur_triton import blur_triton

    p = np.random.default_rng(h * w).random((h, w), dtype=np.float32)
    taps = tuple(float(x) for x in gaussian_taps(sigma))
    got = np.asarray(jax.jit(lambda x: blur_triton(x, taps))(p))
    ref = np.asarray(jax.jit(lambda x: _jnp_blur(x, sigma))(p))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_blur_plane_takes_the_kernel_on_gpu(gpu, monkeypatch):
    from kanter_core_tpu.ops import blur_triton

    calls = []
    real = blur_triton._pass_call
    monkeypatch.setattr(blur_triton, "_pass_call",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    p = np.random.default_rng(1).random((96, 80), dtype=np.float32)
    got = np.asarray(jax.jit(lambda x: blur_plane(x, 1.3))(p))
    assert calls and not any(c[-1] for c in calls), "kernel not compiled for the card"
    ref = np.asarray(jax.jit(lambda x: _jnp_blur(x, 1.3))(p))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_compiled_blur_kernel_vmap_and_grad(gpu):
    from kanter_core_tpu.ops.blur_triton import blur_kernel

    taps = tuple(float(x) for x in gaussian_taps(1.5))
    batch = np.random.default_rng(2).random((3, 64, 96), dtype=np.float32)
    fn = blur_kernel(taps)
    got = np.asarray(jax.jit(jax.vmap(fn))(batch))
    for i in range(3):
        assert np.array_equal(got[i].view(np.uint32), np.asarray(fn(batch[i])).view(np.uint32))
    g = jax.grad(lambda x: jnp.sum(fn(x)) ** 2)(batch[0])
    g_ref = jax.grad(lambda x: jnp.sum(_jnp_blur(x, 1.5)) ** 2)(batch[0])
    np.testing.assert_array_equal(np.asarray(g), np.asarray(g_ref))
