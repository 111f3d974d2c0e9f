"""Pallas-Triton blur kernel parity (interpret mode on CPU).

The kernel (`ops/blur_triton.py`) replays `blur._blur_axis0`'s arithmetic
exactly; on the GPU it runs compiled and `chip_smoke.py` compares it with
the jnp form there. Here interpret mode checks bit-equality across block
boundaries, wrap halos, odd extents and radius > height, and the wrappers'
vmap, gradient, sharding and dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanter_core_tpu.ops.blur import _blur_axis0, blur_plane, gaussian_taps
from kanter_core_tpu.ops.blur_triton import (
    blur_kernel,
    blur_kernel_sharded,
    blur_rows_with_halo,
    blur_triton,
    fits_sharded,
)


def _taps(sigma):
    return tuple(float(w) for w in gaussian_taps(round(float(sigma), 6)))


def _jnp_blur(p, sigma):
    taps = gaussian_taps(round(float(sigma), 6))
    vert = _blur_axis0(p, taps)
    return _blur_axis0(vert.T, taps).T


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize(
    "h,w,sigma",
    [
        (96, 128, 1.0),
        (50, 128, 2.2),  # height not a block multiple
        (200, 256, 5.0),
        (7, 128, 1.0),  # height < one block
        (64, 128, 20.0),  # radius (60) ≈ height: halo wraps more than once
        (24, 100, 15.0),  # radius (45) > height; width not a block multiple
    ],
)
def test_blur_pallas_matches_jnp(h, w, sigma):
    rng = np.random.default_rng(hash((h, w, int(sigma * 10))) % 2**32)
    p = rng.random((h, w), dtype=np.float32)
    # EAGER reference: jitting the whole 2·(2r+1)-tap roll chain trips
    # XLA:CPU's compile-time blowup on many-tap shifted sums; eager is
    # bit-identical to the jitted lowering here (nc_mul forces separately
    # rounded products under jit and eager alike).
    ref = _jnp_blur(p, sigma)
    got = blur_triton(p, _taps(sigma), block=(16, 64), interpret=True)
    assert np.array_equal(_bits(ref), _bits(got))


def test_blur_pallas_halo_rows_match_wrapped_block():
    """The sharded kernel's halo form (rows from explicit halo rows, no row
    wrap) equals the wrapped blur on the interior rows."""
    rng = np.random.default_rng(21)
    p = rng.random((96, 70), dtype=np.float32)
    taps = _taps(2.2)
    r = (len(taps) - 1) // 2
    ref = np.asarray(blur_triton(p, taps, interpret=True))
    lo, hi = 32, 64
    ext = np.concatenate([p[lo - r:lo], p[lo:hi], p[hi:hi + r]], axis=0)
    got = np.asarray(blur_rows_with_halo(ext, taps, interpret=True))
    assert np.array_equal(_bits(ref[lo:hi]), _bits(got))


def test_blur_pallas_chunk_size_invariance():
    rng = np.random.default_rng(3)
    p = rng.random((120, 256), dtype=np.float32)
    taps = _taps(2.0)
    ref = np.asarray(blur_triton(p, taps, block=(8, 32), interpret=True))
    for block in ((16, 128), (32, 64), (128, 256)):
        got = np.asarray(blur_triton(p, taps, block=block, interpret=True))
        assert np.array_equal(_bits(ref), _bits(got)), f"block={block}"


def test_blur_pallas_wrapper_vmaps():
    """The wrapper batches under vmap; batched results equal per-plane calls
    bit-for-bit."""
    taps = _taps(1.5)
    rng = np.random.default_rng(7)
    batch = rng.random((3, 40, 72), dtype=np.float32)
    fn = blur_kernel(taps, True)
    got = np.asarray(jax.jit(jax.vmap(fn))(batch))
    ref = np.stack([np.asarray(fn(b)) for b in batch])
    assert np.array_equal(_bits(got), _bits(ref))


def test_blur_pallas_custom_vjp_matches_jnp_grad():
    """The wrapper's backward (jnp re-trace) agrees with differentiating the
    jnp path directly."""
    taps = _taps(1.0)
    rng = np.random.default_rng(9)
    p = rng.random((32, 48), dtype=np.float32)

    g_pal = jax.grad(lambda x: jnp.sum(blur_kernel(taps, True)(x)) ** 2)(p)
    g_ref = jax.grad(lambda x: jnp.sum(_jnp_blur(x, 1.0)) ** 2)(p)
    np.testing.assert_array_equal(np.asarray(g_ref), np.asarray(g_pal))


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("rows",))


@pytest.mark.parametrize("n,h,w,sigma", [
    (8, 256, 128, 1.0),
    (8, 64, 96, 2.2),    # block_h 8 ≥ radius 7: minimum viable block
    (4, 96, 128, 5.0),
    (1, 96, 128, 2.2),   # single-device mesh
])
def test_blur_pallas_sharded_matches_jnp(n, h, w, sigma):
    """The shard_map'd kernel (ring ppermute halo exchange + per-shard
    kernel) is bit-identical to the jnp wrap formulation — the mesh analog
    of `height_to_normal.rs:55-56`'s toroidal sampling."""
    taps = _taps(sigma)
    assert fits_sharded(h, len(taps), n)
    rng = np.random.default_rng(hash((n, h, w)) % 2**32)
    p = rng.random((h, w), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda x: _jnp_blur(x, sigma))(p))
    got = np.asarray(jax.jit(blur_kernel_sharded(taps, _mesh(n), "rows", True))(p))
    assert np.array_equal(_bits(ref), _bits(got))


def test_blur_pallas_sharded_gates():
    """Geometries the sharded kernel cannot serve fall back to jnp: rows not
    divisible by the mesh, blocks smaller than the halo."""
    assert not fits_sharded(100, 7, 8)  # 100 % 8 != 0
    assert not fits_sharded(64, 31, 8)  # block 8 < radius 15
    assert fits_sharded(256, 7, 8)
    assert fits_sharded(64, 17, 8)  # block 8 == radius 8


def _count_passes(monkeypatch):
    from kanter_core_tpu.ops import blur as blur_mod
    from kanter_core_tpu.ops import blur_triton

    monkeypatch.setattr(blur_mod, "FORCE_PALLAS_INTERPRET", True)
    calls = []
    real = blur_triton._pass_call

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(blur_triton, "_pass_call", counting)
    return calls


def test_blur_plane_sharded_dispatch_and_grad(monkeypatch):
    """blur_plane(mesh=…) + FORCE_PALLAS_INTERPRET routes through the
    shard_map'd kernel (halo-form vertical pass traced) and its custom_vjp
    backward agrees with differentiating the jnp path."""
    calls = _count_passes(monkeypatch)
    mesh = _mesh(8)
    rng = np.random.default_rng(13)
    p = rng.random((64, 128), dtype=np.float32)
    got = np.asarray(jax.jit(lambda x: blur_plane(x, 1.7, mesh=mesh))(p))
    ref = np.asarray(jax.jit(lambda x: _jnp_blur(x, 1.7))(p))
    assert any(c[4] for c in calls), "sharded kernel path was not traced"
    assert np.array_equal(got, ref)

    g_pal = jax.grad(lambda x: jnp.sum(blur_plane(x, 1.7, mesh=mesh)) ** 2)(p)
    g_ref = jax.grad(lambda x: jnp.sum(_jnp_blur(x, 1.7)) ** 2)(p)
    np.testing.assert_array_equal(np.asarray(g_ref), np.asarray(g_pal))


def test_batched_graph_mesh_keeps_sharded_pallas(monkeypatch):
    """A BatchedGraph over a batch×rows mesh keeps the kernel blur: the
    shard_map'd kernel shards over the ROWS axis and composes with the
    batch vmap, bit-identically to the jnp lowering."""
    from jax.sharding import Mesh

    from kanter_core_tpu import Node, NodeGraph, NodeType, SlotId
    from kanter_core_tpu.parallel import BatchedGraph

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    calls = _count_passes(monkeypatch)

    graph = NodeGraph()
    gin = graph.add_node(Node(NodeType.InputGray("in")))
    bl = graph.add_node(Node(NodeType.Blur(1.5)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(gin, bl, SlotId(0), SlotId(0))
    graph.connect(bl, out, SlotId(0), SlotId(0))

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("batch", "rows"))
    key = f"input_{int(gin)}"
    bg = BatchedGraph(graph, batch_keys={key}, targets=[(out, SlotId(0))], mesh=mesh)
    batch = np.random.default_rng(3).random((4, 64, 128), dtype=np.float32)
    result = bg(**{key: (bg.shard_batch_arg(batch),)})
    got = np.asarray(result[(out, SlotId(0))][0])
    assert any(c[4] for c in calls), "sharded kernel was not traced under the batch mesh"
    ref = np.stack([np.asarray(jax.jit(lambda x: _jnp_blur(x, 1.5))(b)) for b in batch])
    assert np.array_equal(got, ref)


def test_blur_plane_dispatch_is_jnp_on_cpu(monkeypatch):
    """On the CPU backend blur_plane keeps the plain jnp lowering (the
    kernel route is the GPU's); golden bit-exactness depends on it."""
    from kanter_core_tpu.ops import blur_triton

    monkeypatch.setattr(blur_triton, "_pass_call", None)  # any use would raise
    rng = np.random.default_rng(11)
    p = rng.random((33, 100), dtype=np.float32)
    a = np.asarray(jax.jit(lambda x: blur_plane(x, 2.2))(p))
    b = np.asarray(jax.jit(lambda x: _jnp_blur(x, 2.2))(p))
    assert np.array_equal(a, b)
