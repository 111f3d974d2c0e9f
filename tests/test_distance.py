"""Distance node (extension): jump-flooded toroidal distance fade vs a
bitwise numpy oracle (a twin of the exact JFA pass order), exact-Euclidean
checks on layouts where JFA is provably exact, max_dist-as-argument
caching, the bucketed-fallback contract, and four-consumer parity."""

import numpy as np
import pytest

from conftest import render_u8

from kanter_core_tpu import (
    Node,
    NodeGraph,
    NodeState,
    NodeType,
    SlotId,
    TextureProcessor,
)
from kanter_core_tpu.compiler import CompiledGraph, graph_fingerprint
from kanter_core_tpu.errors import TexProError
from kanter_core_tpu.ops.distance import _FAR, _jfa_steps


def _oracle(mask: np.ndarray, max_dist: float) -> np.ndarray:
    """numpy twin of ops/distance.distance_plane: same i32 propagation
    (STEP-BATCHED — the eight candidates of a step all roll the
    step-start state), same pass/offset order, same final f32 ops (np
    sqrt/divide are IEEE, matching corrected_sqrt/corrected_div on every
    backend). Deliberately UNPACKED (y/x planes, not y<<16|x): identical
    integers through a different representation also re-proves the
    kernel's pack/unpack lossless."""
    h, w = mask.shape
    rows = np.broadcast_to(np.arange(h, dtype=np.int32)[:, None], (h, w)).copy()
    cols = np.broadcast_to(np.arange(w, dtype=np.int32)[None, :], (h, w)).copy()
    seed = mask > np.float32(0.5)
    far = np.int32(_FAR)
    best_y = np.where(seed, rows, far)
    best_x = np.where(seed, cols, far)

    def d2_of(cy, cx):
        dy = np.abs(rows - cy)
        dy = np.where(dy > h // 2, h - dy, dy)
        dx = np.abs(cols - cx)
        dx = np.where(dx > w // 2, w - dx, dx)
        valid = cy < far
        dy = np.where(valid, dy, 0)
        dx = np.where(valid, dx, 0)
        return np.where(valid, dy * dy + dx * dx, far).astype(np.int64)

    for k in _jfa_steps(h, w):
        best_yy, best_xx = best_y, best_x
        best_d2 = d2_of(best_y, best_x)
        for oy in (-k, 0, k):
            for ox in (-k, 0, k):
                if oy == 0 and ox == 0:
                    continue
                cy, cx = best_y, best_x  # step-start state
                if h > 1 and oy % h != 0:
                    cy = np.roll(cy, oy, axis=0)
                    cx = np.roll(cx, oy, axis=0)
                if w > 1 and ox % w != 0:
                    cy = np.roll(cy, ox, axis=1)
                    cx = np.roll(cx, ox, axis=1)
                d2 = d2_of(cy, cx)
                better = d2 < best_d2
                best_yy = np.where(better, cy, best_yy)
                best_xx = np.where(better, cx, best_xx)
                best_d2 = np.where(better, d2, best_d2)
        best_y, best_x = best_yy, best_xx

    dist = np.sqrt(d2_of(best_y, best_x).astype(np.float32), dtype=np.float32)
    fade = (np.float32(1.0)
            - (dist / np.maximum(np.float32(max_dist), np.float32(1e-6)))
            .astype(np.float32))
    return np.clip(fade, 0.0, 1.0)


def _build(max_dist=8.0):
    g = NodeGraph()
    pat = g.add_node(Node(NodeType.Pattern(
        97, 83, "Checker", cells_x=4, cells_y=3, mortar=0.3, bevel=0.0, seed=2
    )))
    ds = g.add_node(Node(NodeType.Distance(max_dist)))
    g.connect(pat, ds, SlotId(0), SlotId(0))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(ds, out, SlotId(0), SlotId(0))
    return g, ds, out


def test_distance_serde_round_trip():
    g, ds, _ = _build(11.5)
    clone = NodeGraph.from_json(g.to_json())
    assert clone.to_json() == g.to_json()
    assert clone.node(ds).node_type.payload == 11.5


def test_distance_max_dist_is_argument_not_structure():
    g1, _, _ = _build(4.0)
    g2, _, _ = _build(40.0)
    assert graph_fingerprint(g1) == graph_fingerprint(g2)


def test_distance_rejects_bad_max_dist():
    with pytest.raises(TexProError):
        NodeType.Distance(0.0)


@pytest.mark.parametrize("shape", [(33, 41), (1, 17), (19, 1), (2, 2)])
def test_distance_matches_numpy_oracle_bitwise(shape):
    import jax

    from kanter_core_tpu.ops.distance import distance_plane

    rng = np.random.default_rng(sum(shape))
    mask = (rng.random(shape) > 0.9).astype(np.float32)
    got = np.asarray(
        jax.jit(lambda m, d: distance_plane(m, d))(mask, np.float32(7.0))
    )
    assert got.tobytes() == _oracle(mask, 7.0).tobytes()


def test_distance_single_seed_is_exact_euclidean_with_wrap():
    """With one seed JFA is exact: every pixel's fade equals the brute-
    force toroidal Euclidean fade, including wrap paths across both edges
    (the seed sits in a corner)."""
    import jax

    from kanter_core_tpu.ops.distance import distance_plane

    h, w = 23, 31
    mask = np.zeros((h, w), np.float32)
    mask[2, 3] = 1.0
    got = np.asarray(
        jax.jit(lambda m, d: distance_plane(m, d))(mask, np.float32(12.0))
    )
    yy, xx = np.mgrid[0:h, 0:w]
    dy = np.abs(yy - 2)
    dy = np.minimum(dy, h - dy)
    dx = np.abs(xx - 3)
    dx = np.minimum(dx, w - dx)
    ref = np.clip(
        np.float32(1.0)
        - np.sqrt((dy * dy + dx * dx).astype(np.float32)) / np.float32(12.0),
        0.0, 1.0,
    )
    assert got.tobytes() == ref.astype(np.float32).tobytes()
    assert got[2, 3] == 1.0


def test_distance_degenerate_masks():
    import jax

    from kanter_core_tpu.ops.distance import distance_plane

    f = jax.jit(lambda m, d: distance_plane(m, d))
    # seedless: the sentinel saturates the fade to 0 everywhere
    assert (np.asarray(f(np.zeros((9, 9), np.float32), np.float32(5.0))) == 0).all()
    # all seeds: distance 0 everywhere → fade 1
    assert (np.asarray(f(np.ones((9, 9), np.float32), np.float32(5.0))) == 1).all()
    # 1×1 canvas
    assert np.asarray(f(np.ones((1, 1), np.float32), np.float32(5.0)))[0, 0] == 1.0


def test_distance_four_consumer_parity():
    """fused == eager == tiled engine pixels (the tiled twin is band-dense:
    full-height hoist, field recomputed per band, rows sliced). The tiny
    forcing budget still bands: the band-dense capacity gate keys on
    DEVICE capacity (the auto half-of-HBM bound), not on an explicit
    tile_bytes (test_tiled.py::test_band_dense_distance_capacity_gate
    pins the refusal side)."""
    px = {}
    for mode, kw, auto in (
        ("fused", {}, False),
        ("eager", {}, True),
        ("tiled", {"tile_bytes": 1}, False),
    ):
        tp = TextureProcessor(10_000_000, **kw)
        try:
            g, ds, out = _build()
            lg = tp.new_live_graph()
            with lg.write() as gg:
                gg.set_node_graph(g)
                gg.auto_update = auto
            px[mode] = render_u8(lg, out)
        finally:
            tp.shutdown_now()
    assert np.array_equal(px["fused"], px["eager"])
    assert np.array_equal(px["fused"], px["tiled"])


def test_distance_bucketed_engine_splits_segments():
    """Distance is NOT bucketable (a padded plane cannot wrap-roll): with
    `bucket_sizes=True` the engine SPLITS the partition at the Distance
    boundary (VERDICT r4 #2) — the bucketable segments evaluate through
    cached BucketedGraph evaluators, the Distance segment dense-compiles —
    and the pixels stay bit-identical to the plain dense path."""
    from kanter_core_tpu.bucketed import BucketedGraph, graph_is_bucketable

    g, ds, out = _build()
    assert not graph_is_bucketable(g)
    with pytest.raises(TexProError):
        BucketedGraph(g, targets=[(out, SlotId(0))])

    tp_dense = TextureProcessor(10_000_000)
    tp_bucket = TextureProcessor(10_000_000, bucket_sizes=True)
    try:
        a = b = None
        for tp, store in ((tp_dense, "a"), (tp_bucket, "b")):
            g2, _, out2 = _build()
            lg = tp.new_live_graph()
            with lg.write() as gg:
                gg.set_node_graph(g2)
            if store == "a":
                a = render_u8(lg, out2)
            else:
                b = render_u8(lg, out2)
        assert np.array_equal(a, b)
        # segments went through the bucketed machinery (≥1 cached
        # segment evaluator) and the Distance segment dense-compiled
        assert len(tp_bucket.engine._bucketed_programs) >= 1
        assert len(tp_bucket.engine._fused_programs) >= 1
    finally:
        tp_dense.shutdown_now()
        tp_bucket.shutdown_now()


def test_distance_spread_drag_reuses_program():
    """max_dist edits ride as arguments: pixels change, fused program count
    does not grow past the partition split; the setter rejects non-Distance
    nodes."""
    tp = TextureProcessor(10_000_000)
    try:
        g, ds, out = _build()
        lg = tp.new_live_graph()
        with lg.write() as gg:
            gg.set_node_graph(g)
        renders = [render_u8(lg, out)]
        for spread in (3.0, 14.0, 30.0):
            with lg.write() as gg:
                gg.set_distance(ds, spread)
                assert gg.node_state(ds) == NodeState.DIRTY
            renders.append(render_u8(lg, out))
        for a, b in zip(renders, renders[1:]):
            assert not np.array_equal(a, b), "distance edit did not change pixels"
        assert len(tp.engine._fused_programs) == 2
        with lg.write() as gg:
            with pytest.raises(TexProError):
                gg.set_distance(out, 1.0)  # not a Distance node
    finally:
        tp.shutdown_now()


def test_distance_rejects_rgba_input():
    from conftest import HEART_128

    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image(str(HEART_128))))
    ds = g.add_node(Node(NodeType.Distance()))
    with pytest.raises(TexProError):
        g.connect(img, ds, SlotId(0), SlotId(0))  # GRAY slot refuses RGBA


def test_distance_packed_bound_raises_texpro_error():
    """ADVICE r4: the packed-JFA canvas bound (h<=32767: row coords ride
    in y<<16) must survive `python -O` and surface as a diagnosable
    TexProError, not a bare AssertionError. w=1 keeps the array tiny."""
    import numpy as np

    from kanter_core_tpu.ops.distance import distance_plane

    mask = np.zeros((32768, 1), np.float32)
    with pytest.raises(TexProError):
        distance_plane(mask, 8.0)
