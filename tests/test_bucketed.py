"""Shape-bucketed evaluation (`kanter_core_tpu.bucketed`) — compile counts
and bit parity vs the unbucketed fused compiler.

The bucketed evaluator is the FOURTH lockstep consumer of the op set
(eager / fused / tiled / bucketed); these tests enforce its half of the
contract: bit-identical pixels at every size, executables shared per size
bucket.
"""

import numpy as np
import pytest

from conftest import HEART_128
from test_fuzz_equivalence import _build_random_graph

from kanter_core_tpu import (
    MixType,
    Node,
    NodeGraph,
    NodeType,
    ResizePolicy,
    Size,
    SlotId,
)
from kanter_core_tpu.bucketed import BucketedGraph, bucket_of
from kanter_core_tpu.compiler import CompiledGraph


def _assert_planes_equal(ref, got, label=""):
    """Bit-compare plane lists with an explicit length check — a bare zip
    would silently compare nothing if one side dropped planes. NaN payloads
    are out of the contract (conftest.planes_bit_equal has the rationale)."""
    from conftest import planes_bit_equal

    assert len(ref) == len(got), f"{label}: {len(ref)} vs {len(got)} planes"
    for r, gp in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == np.asarray(gp).shape, label
        assert planes_bit_equal(r, np.asarray(gp)), f"{label} diverged"


def _drag_chain(w=300, h=300):
    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image(str(HEART_128))))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    g.connect(img, sep, SlotId(0), SlotId(0))
    val = g.add_node(Node(NodeType.Value(0.7)))
    mix = Node(NodeType.Mix(MixType.MULTIPLY))
    mix.resize_policy = ResizePolicy.SpecificSize(Size(w, h))
    mix = g.add_node(mix)
    g.connect(sep, mix, SlotId(0), SlotId(0))
    g.connect(val, mix, SlotId(0), SlotId(1))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    g.connect(mix, h2n, SlotId(0), SlotId(0))
    bl = g.add_node(Node(NodeType.Blur(1.3)))
    g.connect(h2n, bl, SlotId(0), SlotId(0))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(bl, out, SlotId(0), SlotId(0))
    return g, mix, out


def _ref(graph_builder, w, h, out_key):
    g, _, out = graph_builder(w, h)
    return [
        np.asarray(p)
        for p in CompiledGraph(g, targets=[(out, SlotId(0))])()[(out, SlotId(0))]
    ]


def test_size_drag_compiles_per_bucket():
    """VERDICT r2 missing #5 'done' criterion: a size drag compiles once
    per bucket crossed, not once per size, with bit-exact unpadded output
    vs the unbucketed path at sampled sizes. (Drag range 360→560 px — two
    buckets at 256: 512 and 768 — keeps the single-core CPU suite fast;
    scripts/bench_bucketed.py runs the 1000→1400 spec drag on the GPU.)"""
    g, mix, out = _drag_chain()
    bg = BucketedGraph(g, targets=[(out, SlotId(0))])

    sizes = list(range(360, 561, 10))  # 21 sizes
    checked = {360, 460, 560}
    for s in sizes:
        bg.set_size(mix, Size(s, s))
        got = bg()[(out, SlotId(0))]
        if s in checked:
            ref = _ref(_drag_chain, s, s, out)
            _assert_planes_equal(ref, got, f"size {s}")
    assert bg.traces <= 2, f"{bg.traces} compiles for {len(sizes)} sizes"


def test_mixed_aspect_drags_bit_exact():
    """Irregular aspect drags (up/down per axis, sub-bucket sizes) stay
    bit-exact; buckets shared where pad targets coincide."""
    g, mix, out = _drag_chain()
    bg = BucketedGraph(g, targets=[(out, SlotId(0))])
    for w, h in [(300, 300), (301, 290), (512, 200), (97, 411), (55, 710), (411, 97)]:
        bg.set_size(mix, Size(w, h))
        got = bg()[(out, SlotId(0))]
        ref = _ref(_drag_chain, w, h, out)
        _assert_planes_equal(ref, got, f"{w}x{h}")


@pytest.mark.parametrize("seed", range(5))
def test_bucketed_fuzz_matches_compiled(seed):
    """Random op-soup graphs evaluate bit-identically through the bucketed
    evaluator, including after random SpecificSize edits (the lockstep
    fuzz contract extended to the fourth consumer)."""
    rng = np.random.default_rng(1000 + seed)
    graph, _ = _build_random_graph(seed, allow_graph_nodes=False, bucketable_only=True)

    with_children = {e.output_id for e in graph.edges}
    targets = [
        (n.node_id, SlotId(0)) for n in graph.nodes if n.node_id not in with_children
    ]
    bg = BucketedGraph(graph, targets=targets)

    resizable = [
        n.node_id
        for n in graph.nodes
        if any(e.input_id == n.node_id for e in graph.edges)
    ]
    for round_ in range(2):
        if round_ > 0 and resizable:
            nid = resizable[rng.integers(len(resizable))]
            bg.set_size(
                nid, Size(int(rng.integers(20, 300)), int(rng.integers(20, 300)))
            )
        got = bg()
        ref_prog = CompiledGraph(graph, targets=targets)
        ref = ref_prog()
        for key in targets:
            k = (key[0], SlotId(key[1]))
            _assert_planes_equal(ref[k], got[k], f"seed {seed} {k}")


def test_engine_bucket_sizes_drag():
    """TextureProcessor(bucket_sizes=True): SpecificSize drags through the
    LIVE engine route to the bucketed evaluator — one cached evaluator, one
    compile per size bucket (clean-boundary planes arrive as preset
    bindings on re-dispatches) — and every size stays bit-identical to the
    plain dense processor."""
    from conftest import render_u8
    from kanter_core_tpu import TextureProcessor

    def build(g):
        img = g.add_node(Node(NodeType.Image(str(HEART_128))))
        sep = g.add_node(Node(NodeType.SeparateRgba()))
        g.connect(img, sep, SlotId(0), SlotId(0))
        val = g.add_node(Node(NodeType.Value(0.7)))
        mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        g.connect(sep, mix, SlotId(0), SlotId(0))
        g.connect(val, mix, SlotId(0), SlotId(1))
        h2n = g.add_node(Node(NodeType.HeightToNormal()))
        g.connect(mix, h2n, SlotId(0), SlotId(0))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(h2n, out, SlotId(0), SlotId(0))
        return mix, out

    sizes = [(300, 300), (310, 300), (340, 330), (97, 411), (350, 300)]
    plain = TextureProcessor(10_000_000)
    bucketed_tp = TextureProcessor(10_000_000, bucket_sizes=True)
    try:
        lg_p = plain.new_live_graph()
        with lg_p.write() as g:
            mix_p, out_p = build(g)
        lg_b = bucketed_tp.new_live_graph()
        with lg_b.write() as g:
            mix_b, out_b = build(g)

        for w, h in sizes:
            for lg, mix in ((lg_p, mix_p), (lg_b, mix_b)):
                with lg.write() as g:
                    g.node_mut(mix).resize_policy = ResizePolicy.SpecificSize(Size(w, h))
            a = render_u8(lg_p, out_p)
            b = render_u8(lg_b, out_b)
            assert np.array_equal(a, b), f"{w}x{h} diverged through the engine"

        assert len(bucketed_tp.engine._bucketed_programs) >= 1
        traces = sum(
            ev.traces for ev in bucketed_tp.engine._bucketed_programs.values()
        )
        # 5 sizes land in ≤3 bucket signatures (512², 512×512 variants, 512×128)
        assert traces <= 4, f"{traces} bucketed compiles for {len(sizes)} sizes"
        assert len(bucketed_tp.engine._fused_programs) == 0, "dense fallback ran"
    finally:
        plain.shutdown_now()
        bucketed_tp.shutdown_now()


def test_tiny_sizes_stay_exact():
    """Sizes ≤16 are not padded (defaults and Value planes keep their exact
    shapes); the pow-2 ladder covers sub-bucket sizes."""
    assert bucket_of(1, 256) == 1
    assert bucket_of(16, 256) == 16
    assert bucket_of(17, 256) == 32
    assert bucket_of(97, 256) == 128
    assert bucket_of(256, 256) == 256
    assert bucket_of(257, 256) == 512
    assert bucket_of(1000, 256) == 1024


def test_bucketed_flattens_nested_graph_nodes():
    """Nested Graph nodes auto-flatten at construction (the tiled
    flattener); a size drag THROUGH the subgraph boundary stays bit-exact
    vs the unbucketed compiler, with result keys on the original nodes."""
    from kanter_core_tpu.graphs import invert_graph

    def build(w, h):
        g = NodeGraph()
        img = g.add_node(Node(NodeType.Image(str(HEART_128))))
        sep = g.add_node(Node(NodeType.SeparateRgba()))
        g.connect(img, sep, SlotId(0), SlotId(0))
        inner = invert_graph()
        gn = Node(NodeType.Graph(inner))
        gn.resize_policy = ResizePolicy.SpecificSize(Size(w, h))
        gn = g.add_node(gn)
        g.connect(sep, gn, SlotId(0), inner.input_slot_id_with_name("in"))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(gn, out, inner.output_slot_id_with_name("out"), SlotId(0))
        return g, gn, out

    g, gn, out = build(150, 140)
    bg = BucketedGraph(g, targets=[(out, SlotId(0))])
    for w, h in [(150, 140), (170, 160), (97, 130)]:
        bg.set_size(gn, Size(w, h))
        got = bg()[(out, SlotId(0))]
        g2, _, out2 = build(w, h)
        ref = CompiledGraph(g2, targets=[(out2, SlotId(0))])()[(out2, SlotId(0))]
        _assert_planes_equal(ref, got, f"{w}x{h}")
    assert bg.traces <= 2


def test_bucketed_rejects_unflattenable_graph_nodes():
    from kanter_core_tpu import TexProError
    from kanter_core_tpu.graphs import invert_graph

    g = NodeGraph()
    inner = invert_graph()
    g.add_node(Node(NodeType.Graph(inner)))  # inner Input has no outer edge
    with pytest.raises(TexProError):
        BucketedGraph(g)


def test_bucketed_shares_aliased_planes():
    """Aliased outputs (Separate's channels re-sharing its input's planes,
    `separate_rgba.rs:38-68`) come back as the SAME array object across
    targets — the `call_with_layout` dedup protocol, now on the bucketed
    path too (DESIGN.md known-limit closure)."""
    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image(str(HEART_128))))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    g.connect(img, sep, SlotId(0), SlotId(0))

    bg = BucketedGraph(
        g,
        targets=[(img, SlotId(0))] + [(sep, SlotId(i)) for i in range(4)],
        device_out=True,
    )
    out = bg()
    for i in range(4):
        assert (
            out[(sep, SlotId(i))][0] is out[(img, SlotId(0))][i]
        ), f"separate slot {i} no longer aliases the image plane"


def test_engine_bucketed_preserves_plane_aliasing():
    """Through the LIVE engine (`bucket_sizes=True`), Separate's committed
    slot datas share their PlaneBuffers with the upstream image's — the
    reference's Arc-shared channel planes survive the bucketed commit (and
    with them the memory-tier byte accounting)."""
    from kanter_core_tpu import LiveGraph, TextureProcessor

    for bucket_sizes in (False, True):  # dense path is the behavior oracle
        tp = TextureProcessor(10_000_000, bucket_sizes=bucket_sizes)
        try:
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.use_cache = True
                img = g.add_node(Node(NodeType.Image(str(HEART_128))))
                sep = g.add_node(Node(NodeType.SeparateRgba()))
                g.connect(img, sep, SlotId(0), SlotId(0))
            with LiveGraph.await_clean_read(lg, sep) as g:
                img_planes = g.slot_data(img, SlotId(0)).image.planes
                for i in range(4):
                    sep_plane = g.slot_data(sep, SlotId(i)).image.planes[0]
                    assert sep_plane is img_planes[i], (
                        f"bucket_sizes={bucket_sizes}: separate slot {i} "
                        "does not share the image's PlaneBuffer"
                    )
            if bucket_sizes:
                assert len(tp.engine._bucketed_programs) >= 1, "bucketed path not used"
        finally:
            tp.shutdown_now()


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_bucketed_mesh_fuzz_matches_compiled(seed):
    """Random op-soup graphs through the MESH-composed bucketed evaluator
    (row-sharded leaves, sharding-constrained compute) stay bit-identical
    to the dense single-device compiler, including across size edits."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("rows",))
    rng = np.random.default_rng(2000 + seed)
    graph, _ = _build_random_graph(seed, allow_graph_nodes=False, bucketable_only=True)

    with_children = {e.output_id for e in graph.edges}
    targets = [
        (n.node_id, SlotId(0)) for n in graph.nodes if n.node_id not in with_children
    ]
    bg = BucketedGraph(graph, targets=targets, mesh=mesh)

    resizable = [
        n.node_id
        for n in graph.nodes
        if any(e.input_id == n.node_id for e in graph.edges)
    ]
    for round_ in range(2):
        if round_ > 0 and resizable:
            nid = resizable[rng.integers(len(resizable))]
            bg.set_size(
                nid, Size(int(rng.integers(20, 300)), int(rng.integers(20, 300)))
            )
        got = bg()
        ref = CompiledGraph(graph, targets=targets)()
        for key in targets:
            k = (key[0], SlotId(key[1]))
            _assert_planes_equal(ref[k], got[k], f"seed {seed} mesh {k}")


def test_payload_edit_retraces_instead_of_serving_stale_weights():
    """A Blur σ edit that keeps the tap COUNT (0.9→1.0, both 7 taps) keeps
    every argument shape, so only the payload fingerprint in the program
    key forces the retrace — without it the jitted executable silently
    reuses the σ=0.9 Gaussian weights baked at the first trace."""
    def build(sigma):
        g = NodeGraph()
        val = g.add_node(Node(NodeType.Value(0.6)))
        mixn = Node(NodeType.Mix(MixType.ADD))
        mixn.resize_policy = ResizePolicy.SpecificSize(Size(64, 64))
        mix = g.add_node(mixn)
        bl = g.add_node(Node(NodeType.Blur(sigma)))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(val, mix, SlotId(0), SlotId(0))
        g.connect(mix, bl, SlotId(0), SlotId(0))
        g.connect(bl, out, SlotId(0), SlotId(0))
        return g, bl, out

    g, bl, out = build(0.9)
    bg = BucketedGraph(g, targets=[(out, SlotId(0))])
    bg()  # trace 1 at σ=0.9
    assert bg.traces == 1

    node = g._node_with_id_mut(bl)
    node.node_type = NodeType.Blur(1.0)
    got = bg()[(out, SlotId(0))]
    assert bg.traces == 2, "σ edit with unchanged tap count did not retrace"

    g2, _, out2 = build(1.0)
    ref = CompiledGraph(g2, targets=[(out2, SlotId(0))])()[(out2, SlotId(0))]
    _assert_planes_equal(ref, got, "stale blur weights")

    # MixType payloads are baked the same way
    mix_id = next(
        n.node_id for n in g.nodes if n.node_type.kind.name == "MIX"
    )
    g._node_with_id_mut(mix_id).node_type = NodeType.Mix(MixType.SUBTRACT)
    bg()
    assert bg.traces == 3, "Mix-type edit did not retrace"


def test_bindings_upcast_to_f32_in_flight():
    """Constructor/with_state plane bindings below f32 must upcast at the
    binding funnel (the bucketed twins call `_h2n_core`/the blur tap loop
    BELOW the eager kernels' entry upcasts): a bf16 input binding must
    produce planes bit-identical to the same values bound as f32, and the
    returned planes must be f32."""
    import jax.numpy as jnp

    g = NodeGraph()
    gin = g.add_node(Node(NodeType.InputGray("in")))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    bl = g.add_node(Node(NodeType.Blur(1.1)))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(gin, h2n, SlotId(0), SlotId(0))
    g.connect(h2n, bl, SlotId(0), SlotId(0))
    g.connect(bl, out, SlotId(0), SlotId(0))

    rng = np.random.default_rng(5)
    plane = rng.random((48, 48), dtype=np.float32)
    quant = np.asarray(jnp.asarray(plane, jnp.bfloat16))  # bf16 host plane

    b16 = BucketedGraph(
        g, targets=[(out, SlotId(0))], bindings={f"input_{int(gin)}": [quant]}
    )
    got = b16()[(out, SlotId(0))]
    assert all(np.asarray(p).dtype == np.float32 for p in got)

    bf32 = BucketedGraph(
        g,
        targets=[(out, SlotId(0))],
        bindings={f"input_{int(gin)}": (np.asarray(quant, np.float32),)},
    )
    want = bf32()[(out, SlotId(0))]
    _assert_planes_equal(want, got, "bf16 binding diverged from f32 upcast")


def test_with_state_handle_graph_is_authoritative_after_autoflatten():
    """A with_state handle on an auto-flattened base evaluator must honor
    the HANDLE's graph: the base's per-call re-flatten of its construction
    original used to overwrite handle.graph, silently discarding edits."""
    from kanter_core_tpu.graphs import invert_graph

    g = NodeGraph()
    val = g.add_node(Node(NodeType.Value(0.25)))
    sub = Node(NodeType.Graph(invert_graph()))
    sub.resize_policy = ResizePolicy.SpecificSize(Size(32, 32))
    sub = g.add_node(sub)
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(val, sub, SlotId(0), SlotId(1))   # inner Input node id 1
    g.connect(sub, out, SlotId(3), SlotId(0))   # inner Output node id 3

    base = BucketedGraph(g, targets=[(out, SlotId(0))])
    first = np.asarray(base()[(out, SlotId(0))][0])
    assert np.allclose(first, 0.75)  # invert(0.25)

    # edit the FLAT graph (what the engine hands to with_state) and re-bind
    edited = base.graph.clone()
    vid = next(n.node_id for n in edited.nodes if n.node_type.kind.name == "VALUE")
    edited._node_with_id_mut(vid).node_type = NodeType.Value(0.5)
    handle = base.with_state(edited, dict(base._bindings))
    second = np.asarray(handle()[(out, SlotId(0))][0])
    assert np.allclose(second, 0.5), (
        "with_state handle's graph was discarded by the base re-flatten"
    )


def test_concurrent_handles_with_different_payloads():
    """Two with_state handles carrying DIFFERENT trace-baked payloads
    (Blur σ with equal tap counts) evaluating concurrently must each get
    their own executable: the payload fingerprint keys the program cache
    and the trace-node table is published under the trace lock, so neither
    handle can serve the other's baked weights."""
    import threading

    def build(sigma):
        g = NodeGraph()
        val = g.add_node(Node(NodeType.Value(0.6)))
        mixn = Node(NodeType.Mix(MixType.ADD))
        mixn.resize_policy = ResizePolicy.SpecificSize(Size(64, 64))
        mix = g.add_node(mixn)
        bl = g.add_node(Node(NodeType.Blur(sigma)))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(val, mix, SlotId(0), SlotId(0))
        g.connect(mix, bl, SlotId(0), SlotId(0))
        g.connect(bl, out, SlotId(0), SlotId(0))
        return g, out

    g9, out = build(0.9)
    base = BucketedGraph(g9, targets=[(out, SlotId(0))])
    g10, _ = build(1.0)

    handles = [base.with_state(g9.clone(), {}), base.with_state(g10.clone(), {})]
    refs = [
        [np.asarray(p) for p in CompiledGraph(g, targets=[(out, SlotId(0))])()[(out, SlotId(0))]]
        for g in (g9, g10)
    ]
    errors = []

    def run(idx):
        try:
            for _ in range(6):
                got = handles[idx]()[(out, SlotId(0))]
                _assert_planes_equal(refs[idx], got, f"handle {idx}")
        except Exception as e:  # noqa: BLE001
            errors.append((idx, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1, 0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
