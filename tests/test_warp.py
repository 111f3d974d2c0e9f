"""Warp node (extension, 19th type): directional-displacement semantics,
exact special cases (mid-gray identity, axis-aligned integer moves), a
numpy f32 oracle replica, the dangling-strength pass-through alias, and
four-consumer lockstep parity (also fuzz-covered via the shared
generator)."""

import numpy as np
import pytest

from conftest import render_u8

from kanter_core_tpu import (
    Node,
    NodeGraph,
    NodeType,
    SlotId,
    TextureProcessor,
)
from kanter_core_tpu.compiler import CompiledGraph, graph_fingerprint
from kanter_core_tpu.errors import TexProError
from kanter_core_tpu.ids import NodeId


def _apply(plane, strength, payload):
    import jax

    from kanter_core_tpu.ops.warp import warp_bindings, warp_planes

    h, w = plane.shape
    b = warp_bindings(NodeType.Warp(*payload).payload)
    out, = jax.jit(warp_planes, static_argnums=(5, 6))(
        (np.asarray(plane, np.float32),),
        np.asarray(strength, np.float32),
        np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32),
        b["k"], h, w,
    )
    return np.asarray(out)


def _np_oracle(plane, strength, payload):
    """Numpy f32 replica of warp_planes' exact op order (numpy never
    FMA-contracts, so with nc_mul on the XLA side the bits must match)."""
    from kanter_core_tpu.ops.warp import warp_bindings

    f = np.float32
    h, w = plane.shape
    b = warp_bindings(NodeType.Warp(*payload).payload)
    kx, ky = b["k"]
    m = np.asarray(strength, np.float32)
    ms = np.clip(m, f(0.0), f(1.0))  # unit-interval contract; NaN ⇒ identity
    ms = np.where(np.isnan(m), f(0.5), ms)
    d = ms - f(0.5)
    u = np.arange(w, dtype=np.int32).astype(np.float32)[None, :] + kx * d
    v = np.arange(h, dtype=np.int32).astype(np.float32)[:, None] + ky * d
    uf = np.clip(np.floor(u), f(-1e9), f(1e9))
    vf = np.clip(np.floor(v), f(-1e9), f(1e9))
    fu, fv = u - uf, v - vf
    x0 = np.mod(uf.astype(np.int32), np.int32(w))
    y0 = np.mod(vf.astype(np.int32), np.int32(h))
    x1 = np.where(x0 + 1 == w, 0, x0 + 1)
    y1 = np.where(y0 + 1 == h, 0, y0 + 1)
    flat = np.asarray(plane, np.float32).reshape(-1)
    n00 = flat[y0 * w + x0]
    n10 = flat[y0 * w + x1]
    n01 = flat[y1 * w + x0]
    n11 = flat[y1 * w + x1]
    nx0 = n00 + fu * (n10 - n00)
    nx1 = n01 + fu * (n11 - n01)
    return nx0 + fv * (nx1 - nx0)


def test_warp_exact_special_cases():
    rng = np.random.default_rng(4)
    plane = rng.random((24, 40), dtype=np.float32)
    # mid-gray map → zero displacement → identity, bit-for-bit
    half = np.full_like(plane, 0.5)
    assert np.array_equal(_apply(plane, half, (137.0, 25.0)), plane)
    # intensity 0 → identity regardless of the map
    m = rng.random(plane.shape, dtype=np.float32)
    assert np.array_equal(_apply(plane, m, (61.0, 0.0)), plane)
    # constant map 1.0 at angle 0, intensity 6 → displace +3 px along +x,
    # i.e. content moves LEFT by 3 == roll by -3 on axis 1
    ones = np.ones_like(plane)
    assert np.array_equal(
        _apply(plane, ones, (0.0, 6.0)), np.roll(plane, -3, axis=1)
    )
    # angle 90 displaces along +y (rows grow downward): roll by -3 on axis 0
    assert np.array_equal(
        _apply(plane, ones, (90.0, 6.0)), np.roll(plane, -3, axis=0)
    )


def test_warp_matches_numpy_oracle_bitwise():
    rng = np.random.default_rng(12)
    for _ in range(12):
        h, w = int(rng.integers(3, 80)), int(rng.integers(3, 80))
        plane = rng.random((h, w), dtype=np.float32)
        strength = (rng.random((h, w), np.float32) * 1.6 - 0.3).astype(np.float32)
        payload = (float(rng.uniform(0, 360)), float(rng.uniform(0.0, 60.0)))
        got = _apply(plane, strength, payload)
        exp = _np_oracle(plane, strength, payload)
        assert np.array_equal(got, exp), payload


def test_warp_nonfinite_strength_deterministic():
    """inf/NaN map values go through clip→cast like Transform's scale=0
    path — run twice, bits equal."""
    plane = np.random.default_rng(1).random((8, 8), dtype=np.float32)
    m = np.full_like(plane, 0.5)
    m[0, 0] = np.inf
    m[1, 1] = np.nan
    m[2, 2] = -np.inf
    a = _apply(plane, m, (33.0, 10.0))
    b = _apply(plane, m, (33.0, 10.0))
    assert np.array_equal(a, b, equal_nan=True)


def _build(payload=(57.0, 18.0), with_strength=True):
    g = NodeGraph()
    nz = g.add_node(Node(NodeType.Noise(72, 56, 4, 3, 5, 0.5)))
    m = g.add_node(Node(NodeType.Noise(72, 56, 3, 2, 21, 0.6)))
    wp = g.add_node(Node(NodeType.Warp(*payload)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(nz, wp, SlotId(0), SlotId(0))
    if with_strength:
        g.connect(m, wp, SlotId(0), SlotId(1))
    g.connect(wp, out, SlotId(0), SlotId(0))
    return g, wp, out


def test_warp_serde_round_trip():
    g, wp, _ = _build()
    clone = NodeGraph.from_json(g.to_json())
    assert clone.to_json() == g.to_json()
    assert clone.node(wp).node_type.payload == g.node(wp).node_type.payload


def test_warp_params_are_arguments_at_bucket_granularity():
    """Angle is always an argument; intensity is an argument WITHIN its
    halo bucket (the bucket is structure — tiled row sets and the mesh
    shard_map bake it, `ops/warp.py::warp_halo`)."""
    from kanter_core_tpu.ops.warp import warp_halo

    # same bucket (halo 16 covers intensities up to 28): shared program
    assert warp_halo(18.0) == warp_halo(25.0) == 16
    assert graph_fingerprint(_build((57.0, 18.0))[0]) == graph_fingerprint(
        _build((310.0, 25.0))[0]
    )
    # crossing a bucket boundary retraces: 2.5 buckets to halo 4
    assert warp_halo(2.5) == 4
    assert graph_fingerprint(_build((57.0, 18.0))[0]) != graph_fingerprint(
        _build((57.0, 2.5))[0]
    )
    # non-finite intensity: unbounded sentinel, its own class
    assert warp_halo(float("nan")) is None
    from kanter_core_tpu.recipe_cache import node_recipe

    r1 = node_recipe(Node(NodeType.Warp(10, 5), NodeId(1)), ["x"], None)
    r2 = node_recipe(Node(NodeType.Warp(10, 6), NodeId(1)), ["x"], None)
    assert r1 != r2


@pytest.mark.parametrize("with_strength", [True, False])
def test_warp_engine_paths_bit_identical(with_strength):
    results = {}
    g, wp, out = _build(with_strength=with_strength)
    for name, fused, tile_bytes in [
        ("fused", True, None),
        ("pernode", False, None),
        ("tiled", True, 1),
    ]:
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            lg = tp.new_live_graph()
            with lg.write() as gg:
                gg.fuse_subgraphs = fused
                gg.set_node_graph(g.clone())
            results[name] = render_u8(lg, out)
        finally:
            tp.shutdown_now()
    prog = CompiledGraph(g.clone(), targets=[(out, SlotId(0))], include_u8=True)
    expect = np.asarray(prog()[(out, SlotId(0))]).reshape(-1)
    for name, px in results.items():
        assert np.array_equal(px, expect), name


def test_warp_bucketed_and_band_parity():
    from kanter_core_tpu.bucketed import BucketedGraph
    from kanter_core_tpu.compiler import collect_value_bindings
    from kanter_core_tpu.tiled import TiledEvaluator

    g, wp, out = _build()
    prog = CompiledGraph(g.clone(), targets=[(out, SlotId(0))])
    expect = [np.asarray(p) for p in prog()[(out, SlotId(0))]]
    for band_rows in (1, 7, 64):
        ev = TiledEvaluator(
            g, [(out, SlotId(0))], collect_value_bindings(g), band_rows=band_rows
        )
        got = ev.run()[(out, SlotId(0))]
        assert all(np.array_equal(a, b) for a, b in zip(got, expect)), band_rows
    bg = BucketedGraph(g, targets=[(out, SlotId(0))], bucket=32)
    got = [np.asarray(p) for p in bg()[(out, SlotId(0))]]
    assert all(np.array_equal(a, b) for a, b in zip(got, expect))


def test_warp_dangling_strength_aliases_input():
    """With slot 1 unconnected the node forwards its input image: through
    the engine commit the Warp output SHARES its producer's PlaneBuffers
    (the reference's Arc-shared planes — no copy), on both scheduler
    paths."""
    from kanter_core_tpu import LiveGraph

    for fused in (True, False):
        g, wp, out = _build(with_strength=False)
        nz = [n.node_id for n in g.nodes
              if n.node_type.kind.value == "Noise"][0]
        tp = TextureProcessor(10_000_000)
        try:
            lg = tp.new_live_graph()
            with lg.write() as gg:
                gg.use_cache = True
                gg.fuse_subgraphs = fused
                gg.set_node_graph(g)
            with LiveGraph.await_clean_read(lg, wp) as gg:
                src_plane = gg.slot_data(nz, SlotId(0)).image.planes[0]
                wp_plane = gg.slot_data(wp, SlotId(0)).image.planes[0]
                assert wp_plane is src_plane, f"fused={fused}: no alias"
        finally:
            tp.shutdown_now()


def test_warp_rgba_and_drag_and_bad_target():
    g = NodeGraph()
    nz = g.add_node(Node(NodeType.Noise(48, 48, 4, 2, 9, 0.5)))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    m = g.add_node(Node(NodeType.Noise(48, 48, 3, 2, 33, 0.5)))
    wp = g.add_node(Node(NodeType.Warp(0.0, 9.0)))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(nz, h2n, SlotId(0), SlotId(0))
    g.connect(h2n, wp, SlotId(0), SlotId(0))
    g.connect(m, wp, SlotId(0), SlotId(1))
    g.connect(wp, out, SlotId(0), SlotId(0))
    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as gg:
            gg.set_node_graph(g)
        before = render_u8(lg, out)
        assert np.all(before.reshape(-1, 4)[:, 3] == 255)  # alpha preserved
        with lg.write() as gg:
            gg.set_warp(wp, 180.0, 21.0)
        after = render_u8(lg, out)
        assert not np.array_equal(before, after)
        with pytest.raises(TexProError):
            lg.set_warp(out, 0, 0)  # not a Warp node
    finally:
        tp.shutdown_now()


def test_warp_tiled_halo_bound_adversarial():
    """Worst-case displacement under tiny bands: strength plateaus at
    exactly 0.0 and 1.0 (the clamp's fixed points), intensity at the top
    edge of its halo bucket (28 → ceil(14)+2 = 16), pure-vertical angles
    both ways — the ±16-of-64-rows hoist stays bit-identical to the dense
    program, proving `warp_halo`'s bound covers the extreme samples."""
    from kanter_core_tpu.compiler import CompiledGraph
    from kanter_core_tpu.tiled import TiledEvaluator

    rng = np.random.default_rng(5)
    h, w = 64, 32
    img_plane = rng.random((h, w), dtype=np.float32)
    m = np.zeros((h, w), np.float32)
    m[::3] = 1.0
    m[1::3] = rng.random((len(range(1, h, 3)), w), np.float32) * 4.0 - 1.5

    for angle in (90.0, 270.0, 33.0):
        g = NodeGraph()
        gi = g.add_node(Node(NodeType.InputGray("img")))
        gm = g.add_node(Node(NodeType.InputGray("m")))
        wp = g.add_node(Node(NodeType.Warp(angle, 28.0)))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(gi, wp, SlotId(0), SlotId(0))
        g.connect(gm, wp, SlotId(0), SlotId(1))
        g.connect(wp, out, SlotId(0), SlotId(0))
        bindings = {
            f"input_{int(gi)}": (img_plane,),
            f"input_{int(gm)}": (m,),
        }
        prog = CompiledGraph(g.clone(), targets=[(out, SlotId(0))])
        expect = np.asarray(prog(**bindings)[(out, SlotId(0))][0])
        for band_rows in (1, 8):
            ev = TiledEvaluator(
                g, [(out, SlotId(0))], bindings, band_rows=band_rows
            )
            got = np.asarray(ev.run()[(out, SlotId(0))][0])
            assert np.array_equal(got, expect), (angle, band_rows)


def test_warp_intensity_edit_across_bucket_boundary_tiled():
    """`set_warp` from intensity 18 (halo bucket 16) to 70 (bucket 64 ⇒
    full-height fallback at h=56) on the TILED engine path: the cached
    evaluator baked bucket-16 row sets, so the fingerprint must key it
    out — both renders match the dense path bit-for-bit."""
    def renders(tile_bytes):
        g, wp, out = _build(payload=(90.0, 18.0))
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            lg = tp.new_live_graph()
            with lg.write() as gg:
                gg.set_node_graph(g)
            first = render_u8(lg, out)
            with lg.write() as gg:
                gg.set_warp(wp, 90.0, 70.0)
            second = render_u8(lg, out)
            if tile_bytes is not None:
                assert len(tp.engine._tiled_programs) >= 2, (
                    "bucket crossing must mint a new tiled evaluator"
                )
            return first, second
        finally:
            tp.shutdown_now()

    dense = renders(None)
    tiled = renders(1)
    assert np.array_equal(dense[0], tiled[0])
    assert np.array_equal(dense[1], tiled[1])


def test_warp_tiled_hoists_only_halo_rows():
    """The capacity point of the unit-interval contract: an interior 8-row
    band of a 1024-row warp needs exactly 8 + 2·halo input rows (was: the
    full 1024 — ancestor-dense bands), and the banded output still matches
    dense bit-for-bit."""
    from kanter_core_tpu.compiler import CompiledGraph
    from kanter_core_tpu.ops.warp import warp_halo
    from kanter_core_tpu.tiled import TiledEvaluator

    rng = np.random.default_rng(9)
    h, w = 1024, 64
    img = rng.random((h, w), dtype=np.float32)
    m = rng.random((h, w), dtype=np.float32)
    g = NodeGraph()
    gi = g.add_node(Node(NodeType.InputGray("img")))
    gm = g.add_node(Node(NodeType.InputGray("m")))
    wp = g.add_node(Node(NodeType.Warp(213.0, 25.0)))  # halo bucket 16
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(gi, wp, SlotId(0), SlotId(0))
    g.connect(gm, wp, SlotId(0), SlotId(1))
    g.connect(wp, out, SlotId(0), SlotId(0))
    bindings = {f"input_{int(gi)}": (img,), f"input_{int(gm)}": (m,)}

    halo = warp_halo(25.0)
    assert halo == 16
    ev = TiledEvaluator(g, [(out, SlotId(0))], bindings, band_rows=8)
    R = ev._band_rows_needed([(out, SlotId(0))], 512, 520)  # interior band
    assert len(R[gi]) == 8 + 2 * halo, len(R[gi])
    assert len(R[gm]) == 8 + 2 * halo, len(R[gm])

    prog = CompiledGraph(g.clone(), targets=[(out, SlotId(0))])
    expect = np.asarray(prog(**bindings)[(out, SlotId(0))][0])
    got = np.asarray(ev.run()[(out, SlotId(0))][0])
    assert np.array_equal(got, expect)


def test_huge_intensity_bindings_skip_pair_table():
    """A huge-but-finite intensity must NOT hang binding collection: the
    bindings are the one f32[2] displacement vector, O(1) host work for any
    intensity (an earlier per-pixel staircase table was O(|kx|+|ky|) and
    spun ~1e9 Python iterations for `NodeType.Warp(10, 1e9)`)."""
    import time

    from kanter_core_tpu.ops.warp import warp_bindings, warp_halo

    t0 = time.perf_counter()
    b = warp_bindings((10.0, 1e9))
    assert time.perf_counter() - t0 < 1.0
    assert set(b) == {"k"} and b["k"].dtype == np.float32
    np.testing.assert_allclose(b["k"], 1e9 * np.array([np.cos(np.deg2rad(10.0)), np.sin(np.deg2rad(10.0))]), rtol=1e-6)
    assert warp_halo(1e9) is not None  # finite ⇒ still a bounded bucket
    assert set(warp_bindings((10.0, 24.0))) == {"k"}
