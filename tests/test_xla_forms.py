"""The plain-XLA forms that run on every backend, against numpy oracles.

Warp and Distance have no hand-written kernel: XLA's native gather and its
fused roll/select steps are what the GPU runs (PERF.md, "Kernels on the
H100"). These tests pin those forms against independent numpy references —
a bilinear toroidal sampler, a brute-force toroidal distance transform, and
a sequential-tap wrap convolution — and pin the sharded forms on the
8-device CPU mesh against unsharded runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanter_core_tpu.ops.blur import blur_plane, gaussian_taps
from kanter_core_tpu.ops.distance import distance_plane
from kanter_core_tpu.ops.warp import (
    fits_mesh,
    warp_bindings,
    warp_halo,
    warp_planes,
    warp_planes_mesh,
)

f32 = np.float32


def _bits(x):
    return np.asarray(x).view(np.uint32)


# --- warp ----------------------------------------------------------------

def _warp_oracle(p, s, k):
    """numpy bilinear wrap sampler in the op's fixed association (f32 ops,
    two roundings per product — numpy never contracts)."""
    h, w = p.shape
    m = np.clip(s, f32(0), f32(1))
    m = np.where(np.isnan(s), f32(0.5), m).astype(f32)
    d = m - f32(0.5)
    u = np.arange(w, dtype=f32)[None, :] + (k[0] * d).astype(f32)
    v = np.arange(h, dtype=f32)[:, None] + (k[1] * d).astype(f32)
    uf, vf = np.floor(u), np.floor(v)
    fu, fv = (u - uf).astype(f32), (v - vf).astype(f32)
    x0 = np.mod(uf.astype(np.int64), w)
    y0 = np.mod(vf.astype(np.int64), h)
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    n00, n10, n01, n11 = p[y0, x0], p[y0, x1], p[y1, x0], p[y1, x1]
    nx0 = n00 + (fu * (n10 - n00)).astype(f32)
    nx1 = n01 + (fu * (n11 - n01)).astype(f32)
    return (nx0 + (fv * (nx1 - nx0)).astype(f32)).astype(f32)


def _warp_gather(p, s, k):
    h, w = p.shape
    idx_r, idx_c = np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32)
    return jax.jit(lambda p_, s_, k_: warp_planes((p_,), s_, idx_r, idx_c, k_, h, w)[0])(p, s, k)


@pytest.mark.parametrize(
    "h,w,angle,intensity",
    [
        (96, 128, 57.0, 6.0),
        (64, 256, 0.0, 16.0),     # axis-aligned, the node's default
        (40, 100, 313.0, 2.0),    # width not a power of two
        (64, 128, 90.0, 14.0),
        (64, 256, 45.0, 0.0),     # zero displacement
        (128, 384, 213.0, 30.0),  # negative-quadrant k, big halo
        (16, 128, 180.0, 3.0),    # small canvas
    ],
)
def test_warp_gather_matches_numpy_oracle(h, w, angle, intensity):
    rng = np.random.default_rng(hash((h, w, int(angle), int(intensity))) % 2**32)
    p = rng.random((h, w), dtype=np.float32)
    s = rng.random((h, w), dtype=np.float32)
    # out-of-contract strengths: clamp + NaN→identity
    s[::7, ::5] = np.nan
    s[1::7, 2::5] = 3.5
    s[2::7, 3::5] = -2.0
    k = warp_bindings((angle, intensity))["k"]
    assert np.array_equal(_bits(_warp_gather(p, s, k)), _bits(_warp_oracle(p, s, k)))


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("rows",))


@pytest.mark.parametrize("n,h,w,angle,intensity", [
    (8, 256, 128, 57.0, 6.0),
    (8, 64, 256, 213.0, 2.0),   # block 8 ≥ halo 4: minimum viable block
    (4, 96, 128, 33.0, 14.0),
    (2, 96, 128, 57.0, 6.0),
])
def test_warp_mesh_sharded_matches_gather(n, h, w, angle, intensity):
    """The shard_map'd gather (ring ppermute of the ±halo rows, global→local
    row remap) is bit-identical to the unsharded gather."""
    halo = warp_halo(intensity)
    assert fits_mesh(h, n, halo)
    k = warp_bindings((angle, intensity))["k"]
    rng = np.random.default_rng(hash((n, h, w)) % 2**32)
    p = rng.random((h, w), dtype=np.float32)
    s = rng.random((h, w), dtype=np.float32) * f32(1.4) - f32(0.2)
    got = jax.jit(lambda p_, s_, k_: warp_planes_mesh(
        (p_,), s_, k_, _mesh(n), "rows", halo, h, w))(p, s, k)[0]
    assert np.array_equal(_bits(got), _bits(_warp_gather(p, s, k)))


def test_fits_mesh_gates():
    assert fits_mesh(64, 8, 4)
    assert not fits_mesh(64, 8, None)  # unbounded displacement
    assert not fits_mesh(64, 1, 4)     # nothing to shard
    assert not fits_mesh(60, 8, 4)     # rows % shards
    assert not fits_mesh(64, 8, 16)    # block 8 < halo 16
    assert not fits_mesh(16, 2, 8)     # block + 2·halo > h


def test_warp_halo_buckets():
    assert warp_halo(0.0) == 4
    assert warp_halo(6.0) == 8      # ceil(3) + 2 = 5 → 8
    assert warp_halo(-18.0) == 16   # sign-free bound
    assert warp_halo(float("inf")) is None
    assert warp_halo(float("nan")) is None


def test_warp_gather_vmaps_and_grads():
    """The gather composes with vmap (BatchedGraph) and grad (autodiff)."""
    rng = np.random.default_rng(5)
    h, w = 24, 40
    ps = rng.random((3, h, w), dtype=np.float32)
    s = rng.random((h, w), dtype=np.float32)
    k = warp_bindings((30.0, 5.0))["k"]
    batched = jax.vmap(lambda p: _warp_gather(p, s, k))(ps)
    for i in range(3):
        assert np.array_equal(_bits(batched[i]), _bits(_warp_gather(ps[i], s, k)))
    g = jax.grad(lambda p: jnp.sum(_warp_gather(p, s, k) ** 2))(ps[0])
    assert g.shape == (h, w) and np.isfinite(np.asarray(g)).all()
    # bilinear weights sum to one, so the gradient mass equals 2·Σ out
    np.testing.assert_allclose(float(jnp.sum(g)),
                               float(2 * jnp.sum(_warp_gather(ps[0], s, k))), rtol=1e-4)


def test_warp_process_uses_mesh_exchange(monkeypatch):
    """The eager per-node consumer routes a viable mesh geometry through the
    shard_map'd exchange and matches the dense gather."""
    from kanter_core_tpu import Node, NodeType, SlotId
    from kanter_core_tpu.ops import warp as warp_mod
    from kanter_core_tpu.slot_data import SlotData
    from kanter_core_tpu.slot_image import SlotImage

    calls = []
    real = warp_mod.warp_planes_mesh
    monkeypatch.setattr(warp_mod, "warp_planes_mesh",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(8)
    p = rng.random((64, 48), dtype=np.float32)
    s = rng.random((64, 48), dtype=np.float32)
    node = Node(NodeType.Warp(20.0, 5.0))
    node.node_id = 7
    datas = [SlotData(node.node_id, SlotId(0), SlotImage.Gray(p)),
             SlotData(node.node_id, SlotId(1), SlotImage.Gray(s))]

    def slot_named(slot_datas, node_, name):
        return datas[0] if name == "input" else datas[1]

    monkeypatch.setattr(warp_mod, "slot_data_with_name", slot_named)
    (out,) = warp_mod.process(datas, node, mesh=_mesh(4))
    assert calls
    k = warp_bindings((20.0, 5.0))["k"]
    got = out.image.planes[0].data()
    assert np.array_equal(_bits(got), _bits(_warp_gather(p, s, k)))


# --- distance ------------------------------------------------------------

def _toroidal_edt_fade(mask, max_dist):
    """Brute-force toroidal distance to the nearest seed (mask > 0.5), as
    the op's fade clip(1 − d/max_dist, 0, 1); f64 distance, f32 fade."""
    h, w = mask.shape
    ys, xs = np.nonzero(mask > 0.5)
    if len(ys) == 0:
        return np.zeros((h, w), np.float32)
    r = np.arange(h)[:, None, None]
    c = np.arange(w)[None, :, None]
    dy = np.abs(r - ys[None, None, :])
    dx = np.abs(c - xs[None, None, :])
    dy = np.minimum(dy, h - dy)
    dx = np.minimum(dx, w - dx)
    d2 = (dy * dy + dx * dx).min(axis=2).astype(np.float32)
    d = np.sqrt(d2)  # correctly rounded f32 sqrt of an exact integer
    fade = np.float32(1) - d / np.float32(max(max_dist, 1e-6))
    return np.clip(fade, 0, 1).astype(np.float32)


def _mask(h, w, seed=0, density=0.02):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.float32)


def _jfa(mask, max_dist=23.0):
    return np.asarray(jax.jit(distance_plane)(mask, np.float32(max_dist)))


@pytest.mark.parametrize("shape,seed", [
    ((64, 128), 1),    # square-ish power of two
    ((256, 128), 2),   # step ladder reaches 128 ≥ H/2 (big far steps)
    ((32, 128), 3),
    ((40, 256), 4),    # H not a power of two (k > H wrap-degenerate steps)
    ((64, 96), 5),     # W not a power of two (ox % W degenerate rolls)
])
def test_jfa_matches_bruteforce_toroidal_edt(shape, seed):
    mask = _mask(*shape, seed=seed)
    got, ref = _jfa(mask), _toroidal_edt_fade(mask, 23.0)
    assert np.array_equal(_bits(got), _bits(ref)), (
        f"{shape}: {int((got != ref).sum())}/{got.size} pixels differ"
    )


def test_jfa_degenerate_masks():
    # all-seed and seedless planes (the sentinel path end to end)
    for mask in (np.ones((32, 48), np.float32), np.zeros((32, 48), np.float32)):
        assert np.array_equal(_bits(_jfa(mask)), _bits(_toroidal_edt_fade(mask, 23.0)))


def test_jfa_dense_seeds_tie_storm():
    """50% density maximizes equal-d² ties; the field is still exact."""
    mask = _mask(48, 64, seed=9, density=0.5)
    assert np.array_equal(_bits(_jfa(mask, 3.0)), _bits(_toroidal_edt_fade(mask, 3.0)))


def test_jfa_odd_extents_and_runtime_max_dist():
    mask = _mask(33, 41, seed=7, density=0.03)
    for md in (1.0, 7.0, 500.0):
        assert np.array_equal(_bits(_jfa(mask, md)), _bits(_toroidal_edt_fade(mask, md)))


def test_jfa_vmap_composition():
    """BatchedGraph vmaps whole programs: stacked results equal per-plane
    calls."""
    masks = np.stack([_mask(32, 48, seed=s) for s in range(3)])
    # max_dist stays a runtime argument: a constant divisor would be
    # rewritten into a reciprocal multiply (CLAUDE.md)
    batched = np.asarray(jax.jit(jax.vmap(distance_plane, in_axes=(0, None)))(
        masks, np.float32(11.0)))
    for i in range(3):
        assert np.array_equal(_bits(batched[i]), _bits(_jfa(masks[i], 11.0))), i


def test_jfa_engine_matches_bruteforce():
    """The fused engine path (Pattern → Distance) renders the exact field."""
    from conftest import render_u8

    from kanter_core_tpu import Node, NodeType, SlotId, TextureProcessor
    from kanter_core_tpu.ops.pattern import pattern_bindings, pattern_planes

    payload = (64, 48, "Checker", 4, 4, 0.3, 0.0, 2)
    with TextureProcessor(10_000_000) as tp:
        lg = tp.new_live_graph()
        with lg.write() as g:
            pat = g.add_node(Node(NodeType.Pattern(
                64, 48, "Checker", cells_x=4, cells_y=4, mortar=0.3, bevel=0.0, seed=2)))
            ds = g.add_node(Node(NodeType.Distance(8.0)))
            out = g.add_node(Node(NodeType.OutputGray("out")))
            g.connect(pat, ds, SlotId(0), SlotId(0))
            g.connect(ds, out, SlotId(0), SlotId(0))
        got = render_u8(lg, out).reshape(48, 64, 4)[..., 0]
    b = pattern_bindings(payload)
    mask = np.asarray(pattern_planes(
        "Checker", b["rows"], b["cols"], b["fx"], b["fy"],
        b["px"], b["py"], b["mortar"], b["bevel"], b["seed"])[0])
    fade = _toroidal_edt_fade(mask, 8.0)
    expect = (np.clip(fade, 0, 1) * np.float32(255)).astype(np.uint8)
    assert np.array_equal(got, expect)


# --- blur ----------------------------------------------------------------

def _blur_oracle(p, sigma):
    """numpy wrap convolution: vertical then horizontal, taps summed in
    order from +0 with separately rounded f32 products."""
    taps = gaussian_taps(round(float(sigma), 6))
    r = (len(taps) - 1) // 2

    def axis0(x):
        acc = np.zeros_like(x)
        for t, wt in enumerate(taps):
            acc = (acc + (np.roll(x, r - t, axis=0) * wt).astype(f32)).astype(f32)
        return acc

    return axis0(axis0(p).T).T


@pytest.mark.parametrize("h,w,sigma", [
    (32, 48, 0.5),
    (37, 53, 1.0),
    (64, 64, 2.2),
    (5, 7, 3.0),     # radius > both extents: the halo wraps many times
    (1, 16, 1.5),    # a single row
    (96, 40, 6.0),
])
def test_jnp_blur_matches_numpy_wrap_convolution(h, w, sigma):
    rng = np.random.default_rng(hash((h, w, int(sigma * 10))) % 2**32)
    p = rng.random((h, w), dtype=np.float32)
    got = jax.jit(lambda x: blur_plane(x, sigma))(p)
    assert np.array_equal(_bits(got), _bits(_blur_oracle(p, sigma)))
