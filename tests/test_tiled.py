"""Blockwise tiled evaluation (`kanter_core_tpu.tiled`) bit parity.

The tiled evaluator must be observably identical to the dense fused
compiler — same bits, any band size — while keeping the per-band device
working set bounded (SURVEY §5's long-canvas analog; the reference can only
spill whole finished planes, `transient_buffer.rs:388-406`).
"""

import numpy as np
import pytest

from conftest import HEART_128, render_u8
from test_fuzz_equivalence import _build_random_graph

from kanter_core_tpu import (
    MixType,
    Node,
    NodeGraph,
    NodeType,
    ResizeFilter,
    ResizePolicy,
    Size,
    SlotId,
    TexProError,
    TextureProcessor,
)
from kanter_core_tpu.compiler import CompiledGraph
from kanter_core_tpu.tiled import TiledEvaluator, graph_is_tileable


def _stencil_graph(g):
    """image → separate → h2n → mix(image) → out, built through a live
    graph handle; exercises decode, aliasing, a wrap stencil, and resize."""
    img = g.add_node(Node(NodeType.Image(str(HEART_128))))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(img, sep, SlotId(0), SlotId(0))
    g.connect(sep, h2n, SlotId(0), SlotId(0))
    g.connect(h2n, mix, SlotId(0), SlotId(0))
    g.connect(img, mix, SlotId(0), SlotId(1))
    g.connect(mix, out, SlotId(0), SlotId(0))
    return out


def _host_bindings(prog: CompiledGraph) -> dict:
    return {
        key: tuple(np.asarray(p) for p in value) if isinstance(value, tuple) else value
        for key, value in prog._bindings.items()
    }


def _assert_tiled_matches(graph, targets, band_rows: int) -> "TiledEvaluator":
    prog = CompiledGraph(graph, targets=targets)
    dense = prog()
    ev = TiledEvaluator(graph, targets, _host_bindings(prog), band_rows=band_rows)
    banded = ev.run()
    for key in targets:
        key = (key[0], SlotId(key[1]))
        dense_planes = dense[key]
        band_planes = banded[key]
        assert len(dense_planes) == len(band_planes)
        from conftest import planes_bit_equal

        for d, b in zip(dense_planes, band_planes):
            # NaN payloads out of contract (conftest.planes_bit_equal)
            assert planes_bit_equal(np.asarray(d), np.asarray(b)), (
                f"bit mismatch at {key}"
            )
    return ev


@pytest.mark.parametrize("seed", range(10))
def test_tiled_matches_compiled_fuzz(seed):
    """Random graphs (mix/separate/combine/h2n/blur, random resize policies
    and filters, irregular sizes): tiled == dense, bit for bit."""
    graph, targets = _build_random_graph(seed, allow_graph_nodes=False)
    if not targets:
        pytest.skip("degenerate graph")
    assert graph_is_tileable(graph)
    _assert_tiled_matches(graph, [(t, SlotId(0)) for t in targets], band_rows=13)


def test_tiled_band_size_invariance():
    """Any band size produces the same bits (odd sizes cross stencil halos
    and resize tap windows at every offset)."""
    graph, targets = _build_random_graph(3)
    assert targets and graph_is_tileable(graph)
    targets = [(t, SlotId(0)) for t in targets]
    prog = CompiledGraph(graph, targets=targets)
    bindings = _host_bindings(prog)
    reference = TiledEvaluator(graph, targets, bindings, band_rows=4096).run()
    for band_rows in (5, 17, 64):
        result = TiledEvaluator(graph, targets, bindings, band_rows=band_rows).run()
        assert set(result) == set(reference)
        for key in result:
            assert len(reference[key]) == len(result[key]), key
            for a, b in zip(reference[key], result[key]):
                assert np.array_equal(a, b), f"band_rows={band_rows} differs at {key}"


def test_tiled_stencil_chain_with_resize():
    """image → upscale(mix with value at SpecificSize) → blur(σ=2) → h2n:
    vertical resize tap windows feed a wrapped blur halo feeding a wrapped
    y-1 stencil — the worst case for row accounting."""
    graph = NodeGraph()
    img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
    val = graph.add_node(Node(NodeType.Value(0.25)))
    mix = Node(NodeType.Mix(MixType.ADD))
    mix.resize_policy = ResizePolicy.SpecificSize(Size(96, 200))
    mix.resize_filter = ResizeFilter.LANCZOS3
    mix = graph.add_node(mix)
    graph.connect(img, mix, SlotId(0), SlotId(0))
    graph.connect(val, mix, SlotId(0), SlotId(1))
    sep = graph.add_node(Node(NodeType.SeparateRgba()))
    graph.connect(mix, sep, SlotId(0), SlotId(0))
    blur = graph.add_node(Node(NodeType.Blur(2.0)))
    graph.connect(sep, blur, SlotId(1), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(blur, h2n, SlotId(0), SlotId(0))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(h2n, out, SlotId(0), SlotId(0))

    for band_rows in (7, 50):
        _assert_tiled_matches(graph, [(out, SlotId(0))], band_rows=band_rows)


def test_tiled_peak_device_bytes_bounded():
    """The per-band working set stays a small fraction of the full result
    footprint — the property that lets a > HBM canvas evaluate at all."""
    graph = NodeGraph()
    val = graph.add_node(Node(NodeType.Value(0.5)))
    big = Node(NodeType.CombineRgba())
    big.resize_policy = ResizePolicy.SpecificSize(Size(512, 512))
    big = graph.add_node(big)
    graph.connect(val, big, SlotId(0), SlotId(0))
    blur_id = graph.add_node(Node(NodeType.Blur(1.0)))  # rgba blur over 512²
    graph.connect(big, blur_id, SlotId(0), SlotId(0))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(blur_id, out, SlotId(0), SlotId(0))

    ev = _assert_tiled_matches(graph, [(out, SlotId(0))], band_rows=32)
    full_bytes = 512 * 512 * 4 * 4  # one rgba result
    assert ev.peak_band_bytes < full_bytes / 2, (
        f"peak band bytes {ev.peak_band_bytes} not bounded vs {full_bytes}"
    )


def test_engine_tiled_path_matches_dense():
    """A TextureProcessor with a tile budget renders the same u8 pixels as a
    dense one, without compiling any dense fused program."""
    def build():
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        sep = graph.add_node(Node(NodeType.SeparateRgba()))
        graph.connect(img, sep, SlotId(0), SlotId(0))
        h2n = graph.add_node(Node(NodeType.HeightToNormal()))
        graph.connect(sep, h2n, SlotId(0), SlotId(0))
        mix = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        graph.connect(h2n, mix, SlotId(0), SlotId(0))
        graph.connect(img, mix, SlotId(0), SlotId(1))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(mix, out, SlotId(0), SlotId(0))
        return graph, out

    results = {}
    for tile_bytes in (None, 1):  # 1 byte: every partition exceeds it
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, out = build()
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            results[tile_bytes] = render_u8(lg, out)
            if tile_bytes is not None:
                assert len(tp.engine._fused_programs) == 0, (
                    "tiled gate did not bypass the dense program"
                )
            tp.remove_live_graph(lg)
        finally:
            tp.shutdown_now()
    assert np.array_equal(results[None], results[1])


def test_engine_tiled_cancel_under_churn():
    """Rapid Value edits while tiled evaluations run exercise the
    between-band cancel poll (tiled's analog of the reference's per-pixel
    cancel, `height_to_normal.rs:45-47`): canceled runs must re-dirty and
    the settled result must match the dense path bit-for-bit."""
    import threading
    import time

    def build():
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        val = graph.add_node(Node(NodeType.Value(0.3)))
        mix = Node(NodeType.Mix(MixType.ADD))
        mix.resize_policy = ResizePolicy.SpecificSize(Size(128, 128))
        mix = graph.add_node(mix)
        graph.connect(img, mix, SlotId(0), SlotId(0))
        graph.connect(val, mix, SlotId(0), SlotId(1))
        sep = graph.add_node(Node(NodeType.SeparateRgba()))
        graph.connect(mix, sep, SlotId(0), SlotId(0))
        h2n = graph.add_node(Node(NodeType.HeightToNormal()))
        graph.connect(sep, h2n, SlotId(0), SlotId(0))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(h2n, out, SlotId(0), SlotId(0))
        return graph, val, out

    results = {}
    for tile_bytes in (None, 1):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, val, out = build()
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            render_u8(lg, out)  # prime

            stop = threading.Event()
            errors: list = []

            def editor():
                try:
                    i = 0
                    while not stop.is_set():
                        with lg.write() as g:
                            g.node_mut(val).node_type = NodeType.Value(
                                0.1 + (i % 7) * 0.05
                            )
                        i += 1
                        time.sleep(0.002)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            t = threading.Thread(target=editor, daemon=True)
            t.start()
            deadline = time.monotonic() + 0.6
            while time.monotonic() < deadline:
                try:
                    render_u8(lg, out)  # races the churn; may be re-dirtied
                except TexProError:
                    pass
                time.sleep(0.005)
            stop.set()
            t.join(timeout=5)
            assert not errors, errors

            with lg.write() as g:
                g.node_mut(val).node_type = NodeType.Value(0.42)
            results[tile_bytes] = render_u8(lg, out)
            tp.remove_live_graph(lg)
        finally:
            tp.shutdown_now()
    assert np.array_equal(results[None], results[1])


def test_tiled_preset_boundary_with_per_slot_sizes():
    """A clean boundary node (here a nested-Graph node, represented purely
    by preset bindings) can emit DIFFERENT sizes per output slot; tiled size
    inference must track sizes per slot, not per node."""
    from kanter_core_tpu import MixType, Node, NodeType

    rng = np.random.default_rng(31)
    big = rng.random((64, 64), dtype=np.float32)
    small = rng.random((24, 40), dtype=np.float32)

    # inner graph with TWO gray outputs → the outer Graph node has two
    # output slots, whose preset data we bind at different sizes
    inner = NodeGraph()
    iin = inner.add_node(Node(NodeType.InputGray("in")))
    out_a = inner.add_node(Node(NodeType.OutputGray("a")))
    out_b = inner.add_node(Node(NodeType.OutputGray("b")))
    inner.connect(iin, out_a, SlotId(0), SlotId(0))
    inner.connect(iin, out_b, SlotId(0), SlotId(0))
    slot_a = inner.output_slot_id_with_name("a")
    slot_b = inner.output_slot_id_with_name("b")

    graph = NodeGraph()
    boundary = graph.add_node(Node(NodeType.Graph(inner)))
    val = graph.add_node(Node(NodeType.Value(0.3)))
    mix_a = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    graph.connect(boundary, mix_a, slot_a, SlotId(0))
    graph.connect(val, mix_a, SlotId(0), SlotId(1))
    mix_b = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    graph.connect(boundary, mix_b, slot_b, SlotId(0))
    graph.connect(val, mix_b, SlotId(0), SlotId(1))
    # cross-size consumer: the small slot's output upscales onto the big one
    mix_c = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    graph.connect(mix_a, mix_c, SlotId(0), SlotId(0))
    graph.connect(mix_b, mix_c, SlotId(0), SlotId(1))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(mix_c, out, SlotId(0), SlotId(0))

    preset = {(boundary, slot_a): 1, (boundary, slot_b): 1}
    bindings = {
        f"preset_{int(boundary)}_{int(slot_a)}": (big,),
        f"preset_{int(boundary)}_{int(slot_b)}": (small,),
    }

    prog = CompiledGraph(graph, targets=[(out, SlotId(0))], preset=preset)
    dense = prog(**{k: tuple(v) for k, v in bindings.items()})[(out, SlotId(0))]

    host = dict(_host_bindings(prog))
    host.update(bindings)
    ev = TiledEvaluator(
        graph, [(out, SlotId(0))], host, preset=preset, band_rows=13
    )
    banded = ev.run()[(out, SlotId(0))]
    assert len(dense) == len(banded)
    for d, b in zip(dense, banded):
        assert np.array_equal(np.asarray(d), b)


def test_engine_tiled_per_node_auto_update():
    """Under auto_update the per-node path (observable incremental commits)
    routes oversized nodes through single-node tiled evaluation — the
    capacity story holds on BOTH scheduler paths, bit-identically."""
    from kanter_core_tpu import Node, NodeType

    def build():
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        sep = graph.add_node(Node(NodeType.SeparateRgba()))
        graph.connect(img, sep, SlotId(0), SlotId(0))
        blur = graph.add_node(Node(NodeType.Blur(1.5)))
        graph.connect(sep, blur, SlotId(0), SlotId(0))
        h2n = graph.add_node(Node(NodeType.HeightToNormal()))
        graph.connect(blur, h2n, SlotId(0), SlotId(0))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(h2n, out, SlotId(0), SlotId(0))
        return graph, out

    results = {}
    for tile_bytes in (None, 1):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, out = build()
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.auto_update = True  # forces the per-node scheduler path
                g.set_node_graph(graph)
            results[tile_bytes] = render_u8(lg, out)
            if tile_bytes is not None:
                # single-node evaluators were cached (blur, h2n, output, …)
                assert len(tp.engine._tiled_programs) >= 2
        finally:
            tp.shutdown_now()
    assert np.array_equal(results[None], results[1])


def test_engine_tiled_evaluator_cache_reuse():
    """Value edits must reuse the cached band programs (one evaluator entry
    across re-dispatches), mirroring the dense path's program cache."""
    from kanter_core_tpu import Node, NodeType

    tp = TextureProcessor(10_000_000, tile_bytes=1)
    try:
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        val = graph.add_node(Node(NodeType.Value(0.2)))
        mix = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
        graph.connect(img, mix, SlotId(0), SlotId(0))
        graph.connect(val, mix, SlotId(0), SlotId(1))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(mix, out, SlotId(0), SlotId(0))

        lg = tp.new_live_graph()
        with lg.write() as g:
            g.set_node_graph(graph)
        first = render_u8(lg, out)
        for v in (0.5, 0.8):
            with lg.write() as g:
                g.node_mut(val).node_type = NodeType.Value(v)
            render_u8(lg, out)
        assert len(tp.engine._tiled_programs) == 1, (
            "value edits must hit the cached tiled evaluator"
        )
        with lg.write() as g:
            g.node_mut(val).node_type = NodeType.Value(0.2)
        assert np.array_equal(render_u8(lg, out), first)
    finally:
        tp.shutdown_now()


def test_engine_tiled_with_write_sink(tmp_path):
    """A Write sink is never fused; with a tile budget its parents evaluate
    row-banded, commit host planes, and the per-node Write then runs off
    that data — the PNG must match the dense processor's."""
    from kanter_core_tpu import Node, NodeType

    def build(out_png):
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        h2n_in = graph.add_node(Node(NodeType.SeparateRgba()))
        graph.connect(img, h2n_in, SlotId(0), SlotId(0))
        h2n = graph.add_node(Node(NodeType.HeightToNormal()))
        graph.connect(h2n_in, h2n, SlotId(0), SlotId(0))
        write = graph.add_node(Node(NodeType.Write(str(out_png))))
        graph.connect(h2n, write, SlotId(0), SlotId(0))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(h2n, out, SlotId(0), SlotId(0))
        return graph, write, out

    pngs = {}
    for tile_bytes in (None, 1):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            out_png = tmp_path / f"w_{tile_bytes}.png"
            graph, write, out = build(out_png)
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            render_u8(lg, out)
            # wait for the Write sink too
            from kanter_core_tpu import LiveGraph

            with LiveGraph.await_clean_write(lg, write):
                pass
            from PIL import Image as PILImage

            pngs[tile_bytes] = np.asarray(PILImage.open(out_png))
        finally:
            tp.shutdown_now()
    assert np.array_equal(pngs[None], pngs[1])


def test_engine_tiled_graph_error_surfaces():
    """A graph error inside a tiled partition (RGBA into a CombineRgba
    slot) must surface on waiters exactly like the dense path (fatal error,
    no hang)."""
    from kanter_core_tpu import Node, NodeType

    tp = TextureProcessor(10_000_000, tile_bytes=1)
    try:
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        comb = graph.add_node(Node(NodeType.CombineRgba()))
        # bypass slot typing (force_connect analog): build the edge directly
        from kanter_core_tpu.edge import Edge

        graph.edges.append(Edge(img, comb, SlotId(0), SlotId(0)))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(comb, out, SlotId(0), SlotId(0))

        lg = tp.new_live_graph()
        with lg.write() as g:
            g.set_node_graph(graph)
        with pytest.raises(TexProError):
            from conftest import render_u8 as _render

            _render(lg, out)
    finally:
        tp.shutdown_now()


def _nested_graph_build():
    from kanter_core_tpu import Node, NodeType
    from kanter_core_tpu.graphs import invert_graph

    graph = NodeGraph()
    img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
    sep = graph.add_node(Node(NodeType.SeparateRgba()))
    graph.connect(img, sep, SlotId(0), SlotId(0))
    inner = invert_graph()
    gn = graph.add_node(Node(NodeType.Graph(inner)))
    graph.connect(sep, gn, SlotId(0), inner.input_slot_id_with_name("in"))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(gn, out, inner.output_slot_id_with_name("out"), SlotId(0))
    return graph, out


def test_engine_tiled_flattens_graph_nodes():
    """VERDICT r2 missing #2: a partition containing a nested Graph node now
    BANDS — `tiled.flatten_graph_nodes` inlines the subgraph (mirroring the
    fused compiler's trace-time inlining, `graph.rs:25-48`) — bit-identically
    to the dense path, across two band budgets."""
    results = {}
    for tile_bytes in (None, 1, 64 * 1024):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, out = _nested_graph_build()
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            results[tile_bytes] = render_u8(lg, out)
            if tile_bytes is not None:
                # banded, NOT the dense fallback
                assert len(tp.engine._tiled_programs) == 1
                assert len(tp.engine._fused_programs) == 0
        finally:
            tp.shutdown_now()
    assert np.array_equal(results[None], results[1])
    assert np.array_equal(results[None], results[64 * 1024])


def test_engine_tiled_multi_output_graph_node():
    """A multi-output nested Graph node bands with each output slot mapped
    back to the Graph node's slots (SlotId(m) ≡ inner NodeId(m))."""
    from kanter_core_tpu import MixType, Node, NodeGraph as NG, NodeType

    def build():
        inner = NG()
        iin = inner.add_node(Node(NodeType.InputGray("in")))
        val = inner.add_node(Node(NodeType.Value(1.0)))
        inv = inner.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
        inner.connect(val, inv, SlotId(0), SlotId(0))
        inner.connect(iin, inv, SlotId(0), SlotId(1))
        o1 = inner.add_node(Node(NodeType.OutputGray("inverted")))
        o2 = inner.add_node(Node(NodeType.OutputGray("passthrough")))
        inner.connect(inv, o1, SlotId(0), SlotId(0))
        inner.connect(iin, o2, SlotId(0), SlotId(0))

        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        sep = graph.add_node(Node(NodeType.SeparateRgba()))
        graph.connect(img, sep, SlotId(0), SlotId(0))
        gn = graph.add_node(Node(NodeType.Graph(inner)))
        graph.connect(sep, gn, SlotId(0), inner.input_slot_id_with_name("in"))
        out1 = graph.add_node(Node(NodeType.OutputGray("a")))
        out2 = graph.add_node(Node(NodeType.OutputGray("b")))
        graph.connect(gn, out1, inner.output_slot_id_with_name("inverted"), SlotId(0))
        graph.connect(gn, out2, inner.output_slot_id_with_name("passthrough"), SlotId(0))
        return graph, gn, out1, out2, inner

    results = {}
    for tile_bytes in (None, 1):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, gn, out1, out2, inner = build()
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            results[tile_bytes] = (render_u8(lg, out1), render_u8(lg, out2))
        finally:
            tp.shutdown_now()
    assert np.array_equal(results[None][0], results[1][0])
    assert np.array_equal(results[None][1], results[1][1])

    # frontier Graph node: request the node itself — its output slots commit
    # under the ORIGINAL (gn, SlotId(m)) keys via the flattener's remap
    frontier = {}
    for tile_bytes in (None, 1):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, gn, out1, out2, inner = build()
            graph.remove_node(out1)
            graph.remove_node(out2)
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            slot = inner.output_slot_id_with_name("inverted")
            frontier[tile_bytes] = render_u8(lg, gn, slot)
            sd = lg.slot_data(gn, slot)
            assert sd.image.planes[0].data().shape == (128, 128)
        finally:
            tp.shutdown_now()
    assert np.array_equal(frontier[None], frontier[1])


def test_auto_capacity_bands_without_config(monkeypatch):
    """VERDICT r2 missing #3: with NO `tile_bytes` configured, a partition
    whose footprint exceeds the device's (here: mocked) memory budget bands
    automatically instead of attempting an unfittable dense program."""
    from kanter_core_tpu.engine import Engine

    ref = None
    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            out = _stencil_graph(g)
        ref = render_u8(lg, out)
    finally:
        tp.shutdown_now()

    monkeypatch.setattr(Engine, "_auto_tile_bytes", lambda self: 1)
    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            out = _stencil_graph(g)
        got = render_u8(lg, out)
        assert len(tp.engine._tiled_programs) == 1
        assert len(tp.engine._fused_programs) == 0
    finally:
        tp.shutdown_now()
    assert np.array_equal(ref, got)


def test_oom_dense_retries_tiled(monkeypatch):
    """A dense program that dies with RESOURCE_EXHAUSTED is retried banded
    once (force-banded even though the footprint estimate undershot) and
    produces bit-identical pixels — capacity degradation with no
    configuration, like the reference's eviction watermark
    (`transient_buffer.rs:388-406`)."""
    from kanter_core_tpu.compiler import CompiledGraph

    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            out = _stencil_graph(g)
        ref = render_u8(lg, out)
    finally:
        tp.shutdown_now()

    def explode(self, **overrides):
        raise RuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate x bytes"
        )

    monkeypatch.setattr(CompiledGraph, "call_with_layout", explode)
    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            out = _stencil_graph(g)
        got = render_u8(lg, out)
        assert len(tp.engine._tiled_programs) == 1
        assert not tp.shutdown.load()
    finally:
        tp.shutdown_now()
    assert np.array_equal(ref, got)


def test_oom_unbandable_raises_clear_error(monkeypatch):
    """VERDICT r2 weak #4: an oversized partition that cannot band (inner
    Embed defeats flattening) surfaces a diagnosable RESOURCE_EXHAUSTED
    TexProError on waiters — graph-fatal, but the processor and its OTHER
    live graphs keep running (no engine shutdown, no hung waiter)."""
    from kanter_core_tpu import Node, NodeGraph as NG, NodeType
    from kanter_core_tpu.compiler import CompiledGraph
    from kanter_core_tpu.errors import ErrorKind
    from kanter_core_tpu.ops.embed import EmbeddedSlotDataId

    def explode(self, **overrides):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(CompiledGraph, "call_with_layout", explode)
    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            inner = NG()
            emb = inner.add_node(Node(NodeType.Embed(EmbeddedSlotDataId(0))))
            o = inner.add_node(Node(NodeType.OutputRgba("out")))
            inner.connect(emb, o, SlotId(0), SlotId(0))
            gn = g.add_node(Node(NodeType.Graph(inner)))
            out = g.add_node(Node(NodeType.OutputRgba("out")))
            g.connect(gn, out, inner.output_slot_id_with_name("out"), SlotId(0))
        with pytest.raises(TexProError) as exc:
            render_u8(lg, out)
        assert exc.value.kind == ErrorKind.RESOURCE_EXHAUSTED
        assert not tp.shutdown.load()

        # a second graph on the SAME processor still evaluates (banded,
        # since the dense path is still monkeypatched to explode)
        lg2 = tp.new_live_graph()
        with lg2.write() as g:
            out2 = _stencil_graph(g)
        assert render_u8(lg2, out2) is not None
    finally:
        tp.shutdown_now()


def test_band_dense_distance_capacity_gate(monkeypatch):
    """VERDICT r3 weak #2: a >budget partition containing Distance cannot
    actually bound its working set by banding (the JFA hoists the FULL
    input height into every band), so the engine must refuse with the
    same diagnosable RESOURCE_EXHAUSTED graph-fatal error the inner-Embed
    unbandable path gets — not OOM, not silently band-dense. The
    processor itself stays alive (graph-fatal only), and a bandable graph
    on the same processor still evaluates."""
    from kanter_core_tpu.engine import Engine
    from kanter_core_tpu.errors import ErrorKind

    # a budget every full-height plane exceeds: 64x64 gray = 16384 B
    monkeypatch.setattr(Engine, "_auto_tile_bytes", lambda self: 8192)
    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            pat = g.add_node(Node(NodeType.Pattern(
                64, 64, "Checker", cells_x=4, cells_y=4,
                mortar=0.3, bevel=0.0, seed=2,
            )))
            ds = g.add_node(Node(NodeType.Distance(8.0)))
            out = g.add_node(Node(NodeType.OutputGray("out")))
            g.connect(pat, ds, SlotId(0), SlotId(0))
            g.connect(ds, out, SlotId(0), SlotId(0))
        with pytest.raises(TexProError) as exc:
            render_u8(lg, out)
        assert exc.value.kind == ErrorKind.RESOURCE_EXHAUSTED
        assert "band-dense" in str(exc.value)
        assert "DISTANCE" in str(exc.value)
        assert not tp.shutdown.load()

        # a bandable graph on the SAME processor still evaluates (banded,
        # under the same tiny budget)
        lg2 = tp.new_live_graph()
        with lg2.write() as g:
            out2 = _stencil_graph(g)
        assert render_u8(lg2, out2) is not None
        assert len(tp.engine._tiled_programs) >= 1
    finally:
        tp.shutdown_now()


def test_band_dense_floor_under_budget_still_bands():
    """Control for the band-dense gate: when the hoisted full-height
    input FITS the budget, a Distance graph still row-bands (band-dense
    but bounded) and stays bit-identical to the dense compiler."""
    g = NodeGraph()
    pat = g.add_node(Node(NodeType.Pattern(
        64, 48, "Checker", cells_x=4, cells_y=3,
        mortar=0.3, bevel=0.0, seed=2,
    )))
    ds = g.add_node(Node(NodeType.Distance(8.0)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(pat, ds, SlotId(0), SlotId(0))
    g.connect(ds, out, SlotId(0), SlotId(0))
    _assert_tiled_matches(g, [(out, SlotId(0))], band_rows=13)


def test_band_dense_floor_covers_transform_and_unbounded_warp():
    """`band_dense_floor_bytes` counts every band-dense kind, not just
    Distance: Transform's affine wrap gather always hoists full height,
    and a Warp becomes band-dense exactly when its halo covers the whole
    height (or the intensity is non-finite); a bounded-halo Warp and
    plain elementwise nodes contribute nothing."""
    from kanter_core_tpu.compiler import collect_value_bindings
    from kanter_core_tpu.tiled import band_dense_floor_bytes, infer_sizes

    def floor_of(mk_node, wire_strength=False):
        g = NodeGraph()
        pat = g.add_node(Node(NodeType.Pattern(
            64, 32, "Checker", cells_x=4, cells_y=2,
            mortar=0.1, bevel=0.0, seed=1,
        )))
        n = g.add_node(mk_node())
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(pat, n, SlotId(0), SlotId(0))
        if wire_strength:
            g.connect(pat, n, SlotId(1), SlotId(1))
        g.connect(n, out, SlotId(0), SlotId(0))
        infos = infer_sizes(g, collect_value_bindings(g), {})
        return band_dense_floor_bytes(infos)

    plane = 4 * 64 * 32
    f, culprits = floor_of(lambda: Node(NodeType.Transform(1.0, 0.0, 0.0, 1.0, 0.3)))
    assert f == plane and "TRANSFORM" in culprits[0]
    # Distance's band fn runs the FULL propagation and slices (tiled.py
    # band loop), so its full-height OUTPUT and packed-i32 JFA STATE are
    # live alongside the input: 3 planes, not 1 (ADVICE r4 undercount fix)
    f, culprits = floor_of(lambda: Node(NodeType.Distance(8.0)))
    assert f == 3 * plane and "DISTANCE" in culprits[0]
    # unbounded-halo warp: intensity covers the whole height; BOTH wired
    # inputs (image + strength map) hoist full height
    f, culprits = floor_of(lambda: Node(NodeType.Warp(10.0, 1e9)),
                           wire_strength=True)
    assert f == 2 * plane and "WARP" in culprits[0]
    # bounded-halo warp: NOT band-dense
    f, culprits = floor_of(lambda: Node(NodeType.Warp(10.0, 4.0)),
                           wire_strength=True)
    assert f == 0 and culprits == []
    # elementwise-only graph: zero floor
    f, culprits = floor_of(lambda: Node(NodeType.Blur(1.0)))
    assert f == 0 and culprits == []


def test_flatten_bails_on_inner_embed_and_unbound_input():
    """`flatten_graph_nodes` refuses graphs whose flattening could not
    preserve semantics — an inner Embed (the embed side-channel is
    per-LiveGraph, empty for a fresh nested graph, `graph.rs:21-22`) or an
    inner Input with consumers but no outer edge (the dense path owns that
    error) — so the engine keeps the dense path's behavior for them."""
    from kanter_core_tpu import Node, NodeGraph as NG, NodeType
    from kanter_core_tpu.ops.embed import EmbeddedSlotDataId
    from kanter_core_tpu import tiled as tiled_mod

    inner = NG()
    emb = inner.add_node(Node(NodeType.Embed(EmbeddedSlotDataId(0))))
    o = inner.add_node(Node(NodeType.OutputRgba("out")))
    inner.connect(emb, o, SlotId(0), SlotId(0))
    graph = NodeGraph()
    gn = graph.add_node(Node(NodeType.Graph(inner)))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(gn, out, inner.output_slot_id_with_name("out"), SlotId(0))
    assert tiled_mod.flatten_graph_nodes(graph, {}, {}) is None

    inner2 = NG()
    iin = inner2.add_node(Node(NodeType.InputGray("in")))
    o2 = inner2.add_node(Node(NodeType.OutputGray("out")))
    inner2.connect(iin, o2, SlotId(0), SlotId(0))
    graph2 = NodeGraph()
    gn2 = graph2.add_node(Node(NodeType.Graph(inner2)))  # input slot unconnected
    out2 = graph2.add_node(Node(NodeType.OutputGray("out")))
    graph2.connect(gn2, out2, inner2.output_slot_id_with_name("out"), SlotId(0))
    assert tiled_mod.flatten_graph_nodes(graph2, {}, {}) is None


def test_engine_tiled_input_and_embed_leaves():
    """Bound InputGray planes and embedded slot data must reach the tiled
    path's host-gathered leaves identically to the dense path."""
    from kanter_core_tpu import EmbeddedSlotDataId, SlotData, SlotImage

    rng = np.random.default_rng(21)
    in_plane = rng.random((40, 48), dtype=np.float32)
    embed_plane = rng.random((40, 48), dtype=np.float32)

    def build_and_render(tile_bytes):
        from kanter_core_tpu import Node, NodeType

        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph = NodeGraph()
            gin = graph.add_node(Node(NodeType.InputGray("g")))
            emb = graph.add_node(Node(NodeType.Embed(EmbeddedSlotDataId(0))))
            mix = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
            graph.connect(gin, mix, SlotId(0), SlotId(0))
            graph.connect(emb, mix, SlotId(0), SlotId(1))
            out = graph.add_node(Node(NodeType.OutputGray("out")))
            graph.connect(mix, out, SlotId(0), SlotId(0))

            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
                g.add_input_slot_data(
                    SlotData(gin, SlotId(0), SlotImage.Gray(in_plane))
                )
                g.embed_slot_data_with_id(
                    SlotData(emb, SlotId(0), SlotImage.Gray(embed_plane)),
                    EmbeddedSlotDataId(0),
                )
            px = render_u8(lg, out)
            if tile_bytes is not None:
                assert len(tp.engine._tiled_programs) >= 1, "tiled path did not run"
                assert len(tp.engine._fused_programs) == 0
            return px
        finally:
            tp.shutdown_now()

    assert np.array_equal(build_and_render(None), build_and_render(1))


def test_engine_tiled_incremental_edit():
    """After a Value edit, the tiled engine path re-evaluates and matches the
    dense path (clean-boundary presets + interior-without-data re-dirty)."""
    def build():
        graph = NodeGraph()
        img = graph.add_node(Node(NodeType.Image(str(HEART_128))))
        val = graph.add_node(Node(NodeType.Value(0.2)))
        mix = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
        graph.connect(img, mix, SlotId(0), SlotId(0))
        graph.connect(val, mix, SlotId(0), SlotId(1))
        out = graph.add_node(Node(NodeType.OutputRgba("out")))
        graph.connect(mix, out, SlotId(0), SlotId(0))
        return graph, val, out

    results = {}
    for tile_bytes in (None, 1):
        tp = TextureProcessor(10_000_000, tile_bytes=tile_bytes)
        try:
            graph, val, out = build()
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
            render_u8(lg, out)  # first pass
            with lg.write() as g:
                g.node_mut(val).node_type = NodeType.Value(0.6)
            results[tile_bytes] = render_u8(lg, out)
            if tile_bytes is not None:
                assert len(tp.engine._tiled_programs) >= 1, "tiled path did not run"
                assert len(tp.engine._fused_programs) == 0
            tp.remove_live_graph(lg)
        finally:
            tp.shutdown_now()
    assert np.array_equal(results[None], results[1])


def test_tiled_mesh_pads_bands_to_shard():
    """Mesh-divisible band padding (DESIGN.md known-limit closure): with
    band row counts that divide the 8-device mesh neither at the band size
    (30) nor after halo expansion, every big leaf band still shards
    (`band_leaf_replicated == 0`) and the result stays bit-identical to the
    unmeshed evaluator."""
    import jax
    from jax.sharding import Mesh

    g = NodeGraph()
    out = _stencil_graph(g)
    bl = g.add_node(Node(NodeType.Blur(1.5)))  # halo-expanded leaf bands
    # splice the blur in front of the output
    out_edge = [e for e in g.edges if e.input_id == out][0]
    g.remove_edge(out_edge)
    g.connect(out_edge.output_id, bl, SlotId(0), SlotId(0))
    g.connect(bl, out, SlotId(0), SlotId(0))

    targets = [(out, SlotId(0))]
    prog = CompiledGraph(graph := g, targets=targets)
    bindings = _host_bindings(prog)
    plain = TiledEvaluator(graph, targets, bindings, band_rows=30).run()

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("rows",))
    ev = TiledEvaluator(graph, targets, bindings, band_rows=30, mesh=mesh)
    meshed = ev.run()
    assert ev.band_leaf_replicated == 0, (
        f"{ev.band_leaf_replicated} big leaf bands stayed replicated"
    )
    for key in plain:
        for a, b in zip(plain[key], meshed[key]):
            assert np.array_equal(a, b), f"mesh band padding changed bits at {key}"

    # the counter is per-run (like peak_band_bytes): a stale value from a
    # previous evaluation must not leak into the next run's count
    ev.band_leaf_replicated = 99
    ev.run()
    assert ev.band_leaf_replicated == 0


def test_tiled_target_that_feeds_another_target_commits_aligned():
    """A target that is ALSO an ancestor of another same-height target
    carries merged halo rows in its band row set — the commit must place
    rows by position, not prefix slice. Regression: image→separate→blur
    with targets=[sep, blur] at band_rows=13 committed sep's plane shifted
    by the blur halo (7859/16384 pixels wrong) before the fix."""
    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image(str(HEART_128))))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    bl = g.add_node(Node(NodeType.Blur(2.0)))
    g.connect(img, sep, SlotId(0), SlotId(0))
    g.connect(sep, bl, SlotId(0), SlotId(0))
    targets = [(sep, SlotId(0)), (bl, SlotId(0))]
    for band_rows in (13, 8, 64):
        _assert_tiled_matches(g, targets, band_rows)


def test_total_plane_bytes_sums_per_slot_sizes():
    """Preset boundary nodes can carry different-sized planes per slot;
    the dense-footprint estimate must sum per slot or the engine's
    dense-vs-tiled gate mis-sizes by the slot delta."""
    from kanter_core_tpu.geometry import Size as Sz
    from kanter_core_tpu.ids import NodeId
    from kanter_core_tpu.tiled import _Info, total_plane_bytes

    info = _Info(Node(NodeType.SeparateRgba()))
    info.out_size = Sz(1, 1)  # last-assigned size (the old formula's input)
    info.out_slot_sizes = {SlotId(0): Sz(2048, 2048), SlotId(1): Sz(1, 1)}
    info.out_planes = {SlotId(0): 4, SlotId(1): 1}
    got = total_plane_bytes({NodeId(1): info})
    assert got == 4 * (2048 * 2048) * 4 + 4 * 1 * 1


def test_tiled_nan_producing_graph_parity():
    """A 0/0 Divide (NaN planes) through the banded twin: NaN POSITIONS and
    all non-NaN bits must match dense exactly; NaN payloads are out of
    contract (the dense compiler's constant zero plane and the tiled twin's
    gathered zero rows lower to different fdivs whose quiet-NaN signs
    differ — measured 0x7fc00000 vs 0xffc00000). Fuzz seed 209 found it."""
    graph, targets = _build_random_graph(209, allow_graph_nodes=False)
    assert targets and graph_is_tileable(graph)
    _assert_tiled_matches(graph, [(t, SlotId(0)) for t in targets], band_rows=7)


def test_ao_at_capacity_bands_through_engine(monkeypatch):
    """A large-radius AO at 4096^2 can exceed device memory — the engine's
    capacity machinery absorbs that case because AO is BANDABLE (halo = ao_max_radius rows). Pin the
    ROUTE at test scale: an AO graph under a budget every full plane
    exceeds goes through the row-banded evaluator (halo 24 < height 128,
    so banding genuinely shrinks the working set) and stays bit-identical
    to the unconstrained dense processor. Radius 2 stands in for the
    radius-8 case: the engine's band routing is radius-independent
    (only the halo row count scales), and radius 8's 193-tap x 3-scale
    chains hit XLA:CPU's compose-chain compile explosion (CLAUDE.md; a
    256^2 dense compile tripped XLA's very-slow-compile alarm when this
    test was first written at radius 8)."""
    from kanter_core_tpu.engine import Engine
    from kanter_core_tpu.ops.ambient_occlusion import ao_max_radius

    assert ao_max_radius(2.0) < 128 // 2  # banding must actually shrink

    def build(g):
        pat = g.add_node(Node(NodeType.Pattern(
            128, 128, "Checker", cells_x=4, cells_y=4,
            mortar=0.2, bevel=0.1, seed=7,
        )))
        ao = g.add_node(Node(NodeType.AmbientOcclusion(2.0, 2.0)))
        g.connect(pat, ao, SlotId(0), SlotId(0))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(ao, out, SlotId(0), SlotId(0))
        return out

    plain = TextureProcessor(10_000_000)
    try:
        lg = plain.new_live_graph()
        with lg.write() as g:
            out = build(g)
        dense = render_u8(lg, out)
    finally:
        plain.shutdown_now()

    # budget smaller than ONE full 128^2 plane (65536 B): the proactive
    # gate must band — the same route a device OOM retry takes
    monkeypatch.setattr(Engine, "_auto_tile_bytes", lambda self: 50_000)
    tp = TextureProcessor(10_000_000)
    try:
        lg2 = tp.new_live_graph()
        with lg2.write() as g:
            out2 = build(g)
        banded = render_u8(lg2, out2)
        assert np.array_equal(banded, dense)
        assert len(tp.engine._tiled_programs) >= 1, "AO did not band"
        assert not tp.shutdown.load()
    finally:
        tp.shutdown_now()
