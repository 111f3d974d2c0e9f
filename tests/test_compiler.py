"""Fused whole-graph compiler tests: parity with the eager engine, program
caching, and argument re-binding."""

import numpy as np
import pytest

from conftest import IMAGE_1, IMAGE_2, INVERT_GRAPH_JSON, golden

from kanter_core_tpu import (
    MixType,
    Node,
    NodeGraph,
    NodeType,
    NodeTypeKind,
    SlotId,
)
from kanter_core_tpu.compiler import CompiledGraph, compile_graph


def _invert_main_graph():
    ig = NodeGraph.from_path(INVERT_GRAPH_JSON)
    main = NodeGraph()
    img = main.add_node(Node(NodeType.Image(IMAGE_2)))
    sep = main.add_node(Node(NodeType.SeparateRgba()))
    gn = main.add_node(Node(NodeType.Graph(ig)))
    out = main.add_node(Node(NodeType.OutputGray("out")))
    main.connect(img, sep, SlotId(0), SlotId(0))
    main.connect(sep, gn, SlotId(0), ig.input_slot_id_with_name("in"))
    main.connect(gn, out, ig.output_slot_id_with_name("out"), SlotId(0))
    return main, ig, gn, out


def test_fused_matches_golden():
    main, _, _, out = _invert_main_graph()
    prog = compile_graph(main, include_u8=True)
    u8 = np.asarray(prog()[(out, SlotId(0))])
    ref = golden("invert_graph_node_import.png")
    assert np.array_equal(u8.reshape(ref.shape), ref)


def test_program_cache_hit():
    """Cache hits share the jitted executable but own their bindings, so
    refreshing Value constants for one caller can't change another's handle."""
    main, ig, gn, _ = _invert_main_graph()
    prog1 = compile_graph(main)
    prog2 = compile_graph(main)
    assert prog1._fn is prog2._fn  # shared executable
    assert prog1._bindings is not prog2._bindings

    # same structure, different Value constant → same executable, fresh binding
    inner_value = next(n.node_id for n in ig.nodes if n.node_type.kind == NodeTypeKind.VALUE)
    main2, ig2, gn2, _ = _invert_main_graph()
    ig2_value = next(n for n in ig2.nodes if n.node_type.kind == NodeTypeKind.VALUE)
    ig2_value.node_type = NodeType.Value(0.5)
    prog3 = compile_graph(main2)
    assert prog3._fn is prog1._fn
    key = f"g{int(gn)}_value_{int(inner_value)}"
    assert float(prog3._bindings[key]) == 0.5
    assert float(prog1._bindings[key]) == 1.0  # earlier handle untouched


def test_value_rebind_without_recompile():
    main, ig, gn, out = _invert_main_graph()
    prog = compile_graph(main, include_u8=True)
    base = np.asarray(prog()[(out, SlotId(0))])
    inner_value = next(
        n.node_id for n in ig.nodes if n.node_type.kind == NodeTypeKind.VALUE
    )
    key = f"g{int(gn)}_value_{int(inner_value)}"
    half = np.asarray(prog(**{key: np.float32(0.5)})[(out, SlotId(0))])
    assert not np.array_equal(base, half)
    again = np.asarray(prog()[(out, SlotId(0))])
    assert np.array_equal(base, again)


def test_fused_matches_engine_mix(tex_pro):
    """The fused program and the eager per-node engine produce identical
    pixels for a multi-op graph with resizing."""
    from conftest import render_u8

    graph = NodeGraph()
    i1 = graph.add_node(Node(NodeType.Image(IMAGE_1)))
    i2 = graph.add_node(Node(NodeType.Image(IMAGE_2)))
    mul = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    val = graph.add_node(Node(NodeType.Value(0.25)))
    add = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(i1, mul, SlotId(0), SlotId(0))
    graph.connect(i2, mul, SlotId(0), SlotId(1))
    graph.connect(mul, add, SlotId(0), SlotId(0))
    graph.connect(val, add, SlotId(0), SlotId(1))
    graph.connect(add, out, SlotId(0), SlotId(0))

    prog = CompiledGraph(graph, targets=[(out, SlotId(0))], include_u8=True)
    fused = np.asarray(prog()[(out, SlotId(0))]).reshape(-1)

    lg = tex_pro.new_live_graph()
    with lg.write() as g:
        g.set_node_graph(graph.clone())
    eager = render_u8(lg, out)
    assert np.array_equal(fused, eager)


def test_batched_graph_vmap():
    """BatchedGraph evaluates B canvases in one fused, vmapped program."""
    from kanter_core_tpu.parallel import BatchedGraph

    graph = NodeGraph()
    gin = graph.add_node(Node(NodeType.InputGray("in")))
    val = graph.add_node(Node(NodeType.Value(1.0)))
    sub = graph.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(val, sub, SlotId(0), SlotId(0))
    graph.connect(gin, sub, SlotId(0), SlotId(1))
    graph.connect(sub, out, SlotId(0), SlotId(0))

    key = f"input_{int(gin)}"
    bg = BatchedGraph(graph, batch_keys={key}, targets=[(out, SlotId(0))])
    batch = np.random.default_rng(0).random((4, 32, 32), dtype=np.float32)
    result = bg(**{key: (batch,)})
    plane = np.asarray(result[(out, SlotId(0))][0])
    assert plane.shape == (4, 32, 32)
    assert np.array_equal(plane, np.float32(1.0) - batch)


def test_sharded_batch_eval():
    """DP over an 8-device CPU mesh: outputs keep the batch sharding."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kanter_core_tpu.parallel import BatchedGraph, make_mesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")

    graph = NodeGraph()
    gin = graph.add_node(Node(NodeType.InputGray("in")))
    val = graph.add_node(Node(NodeType.Value(1.0)))
    sub = graph.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(val, sub, SlotId(0), SlotId(0))
    graph.connect(gin, sub, SlotId(0), SlotId(1))
    graph.connect(sub, out, SlotId(0), SlotId(0))

    mesh = make_mesh(8)
    key = f"input_{int(gin)}"
    bg = BatchedGraph(graph, batch_keys={key}, targets=[(out, SlotId(0))], mesh=mesh)
    batch = np.random.default_rng(0).random((8, 32, 32), dtype=np.float32)
    sharded = bg.shard_batch_arg(batch)
    result = bg(**{key: (sharded,)})
    plane = result[(out, SlotId(0))][0]
    assert plane.shape == (8, 32, 32)
    # multi-device execution is BIT-IDENTICAL to single-host math (SURVEY §4's
    # multi-node analog: sharded == single-device)
    assert np.array_equal(np.asarray(plane), np.float32(1.0) - batch)
    assert "batch" in str(plane.sharding)


def test_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_value_edit_reuses_fused_program(tex_pro):
    """Dragging a Value slider must re-run the cached fused program, never
    retrace/recompile (fingerprint normalizes Value constants)."""
    from conftest import render_u8

    lg = tex_pro.new_live_graph()
    with lg.write() as g:
        val = g.add_node(Node(NodeType.Value(0.25)))
        comb = g.add_node(Node(NodeType.CombineRgba()))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(val, comb, SlotId(0), SlotId(0))
        g.connect(comb, out, SlotId(0), SlotId(0))

    assert render_u8(lg, out).tolist() == [63, 0, 0, 255]

    for value, red in [(0.5, 127), (1.0, 255), (0.75, 191)]:
        with lg.write() as g:
            node = g.node_mut(val)  # marks dirty + cancels, like the reference
            node.node_type = NodeType.Value(value)
        assert render_u8(lg, out).tolist() == [red, 0, 0, 255]

    assert len(tex_pro.engine._fused_programs) == 1, "value edits must not recompile"


def test_row_sharded_h2n_halo():
    """Spatial TP: a row-sharded HeightToNormal (wrap stencil) must match the
    unsharded result — XLA GSPMD inserts the halo exchange for jnp.roll."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")

    from kanter_core_tpu.ops.height_to_normal import _h2n_jnp

    h = np.random.default_rng(7).random((64, 128), dtype=np.float32)
    ref = [np.asarray(p) for p in jax.jit(_h2n_jnp)(h)]

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("rows",))
    sharded = jax.device_put(h, NamedSharding(mesh, P("rows", None)))
    out = jax.jit(_h2n_jnp)(sharded)
    for i in range(4):
        assert np.array_equal(ref[i], np.asarray(out[i])), f"plane {i}"
    assert "rows" in str(out[0].sharding)


def test_vmap_bit_transparent():
    """Batched (vmapped) kernels must produce the SAME BITS as per-canvas
    evaluation — BatchedGraph results are interchangeable with single-canvas
    renders (chip_smoke.py checks it on four GPUs too)."""
    import jax

    from kanter_core_tpu import Size
    from kanter_core_tpu.node import MixType, ResizeFilter
    from kanter_core_tpu.ops.blur import blur_plane
    from kanter_core_tpu.ops.height_to_normal import _h2n_jnp
    from kanter_core_tpu.ops.mix import _gray_kernel
    from kanter_core_tpu.ops.resize import resample_plane

    rng = np.random.default_rng(0)
    batch = rng.random((4, 64, 96), dtype=np.float32)
    b2 = rng.random((4, 64, 96), dtype=np.float32)

    unary = [
        lambda x: _h2n_jnp(x)[0],
        lambda x: blur_plane(x, 1.5),
        lambda x: resample_plane(x, Size(48, 32), ResizeFilter.LANCZOS3),
    ]
    for f in unary:
        v = np.asarray(jax.jit(jax.vmap(f))(batch))
        s = np.stack([np.asarray(jax.jit(f)(p)) for p in batch])
        assert np.array_equal(v.view(np.uint32), s.view(np.uint32))

    f2 = _gray_kernel(MixType.POW)
    v = np.asarray(jax.jit(jax.vmap(f2))(batch, b2))
    s = np.stack([np.asarray(f2(p, q)) for p, q in zip(batch, b2)])
    assert np.array_equal(v.view(np.uint32), s.view(np.uint32))


def test_row_sharded_blur_halo():
    """Row-sharded Blur (wrap taps via jnp.roll) must match unsharded —
    GSPMD inserts the halo exchange, exactly like the h2n stencil."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")

    from kanter_core_tpu.ops.blur import blur_plane

    h = np.random.default_rng(8).random((64, 128), dtype=np.float32)
    f = jax.jit(lambda x: blur_plane(x, 1.5))
    ref = np.asarray(f(h))

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("rows",))
    sharded = jax.device_put(h, NamedSharding(mesh, P("rows", None)))
    out = f(sharded)
    assert np.array_equal(ref, np.asarray(out))


def test_image_edit_redecodes(tmp_path, tex_pro):
    """Dirtying an Image node re-reads the file even when the cached fused
    program was compiled against old pixels."""
    from PIL import Image as PILImage
    from conftest import render_u8

    path = str(tmp_path / "img.png")
    PILImage.new("RGBA", (8, 8), (10, 20, 30, 255)).save(path)

    lg = tex_pro.new_live_graph()
    with lg.write() as g:
        img = g.add_node(Node(NodeType.Image(path)))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(img, out, SlotId(0), SlotId(0))
    first = render_u8(lg, out).reshape(8, 8, 4)
    assert tuple(first[0, 0]) == (10, 20, 30, 255)

    PILImage.new("RGBA", (8, 8), (200, 100, 50, 255)).save(path)
    with lg.write() as g:
        g.set_image_node_path(img, path)  # dirties; fingerprint unchanged
    second = render_u8(lg, out).reshape(8, 8, 4)
    assert tuple(second[0, 0]) == (200, 100, 50, 255)


def test_fused_combine_rgba_input_is_fatal(tex_pro):
    """An RGBA image wired into a CombineRgba slot errors on the fused path
    exactly like the eager op (not a silent red-channel pick)."""
    import pytest
    from kanter_core_tpu import LiveGraph, TexProError
    from conftest import IMAGE_1 as IMG

    lg = tex_pro.new_live_graph()
    with lg.write() as g:
        i1 = g.add_node(Node(NodeType.Image(IMG)))
        i2 = g.add_node(Node(NodeType.Image(IMG)))
        mix = g.add_node(Node(NodeType.Mix(MixType.ADD)))  # RGBA out, GrayOrRgba slot
        comb = g.add_node(Node(NodeType.CombineRgba()))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(i1, mix, SlotId(0), SlotId(0))
        g.connect(i2, mix, SlotId(0), SlotId(1))
        g.connect(mix, comb, SlotId(0), SlotId(0))  # GrayOrRgba fits Gray
        g.connect(comb, out, SlotId(0), SlotId(0))
    with pytest.raises(TexProError):
        with LiveGraph.await_clean_read(lg, out):
            pass


def test_orphan_live_graph_collected():
    """Dropping every external reference to a live graph lets the engine's
    refcount GC collect it (reference: Arc strong count 1)."""
    import gc
    import time

    from kanter_core_tpu import TextureProcessor

    tp = TextureProcessor(10_000_000)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.add_node(Node(NodeType.Value(0.5)))
        assert len(tp.live_graphs_snapshot()) == 1
        del lg, g
        gc.collect()
        deadline = time.time() + 10
        while time.time() < deadline and tp.live_graphs_snapshot():
            time.sleep(0.02)
        assert tp.live_graphs_snapshot() == []
    finally:
        tp.shutdown_now()


def test_sharded_matches_unsharded_golden():
    """The invert pipeline evaluated with batch-sharded inputs over 8 devices
    is bit-identical to the unsharded single-device evaluation (the
    reference's 'multi-node' test analog, SURVEY §4)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kanter_core_tpu.parallel import BatchedGraph, make_mesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")

    from kanter_core_tpu.graphs import invert_graph

    graph = invert_graph()
    inner_in = graph.input_slot_id_with_name("in")
    out = graph.output_ids()[0]

    # wrap: InputGray at the top level binds via input_<id> program args
    outer = NodeGraph()
    gin = outer.add_node(Node(NodeType.InputGray("in")))
    gnode = outer.add_node(Node(NodeType.Graph(graph)))
    gout = outer.add_node(Node(NodeType.OutputGray("out")))
    outer.connect(gin, gnode, SlotId(0), inner_in)
    outer.connect(gnode, gout, graph.output_slot_id_with_name("out"), SlotId(0))

    key = f"input_{int(gin)}"
    batch = np.random.default_rng(3).random((8, 48, 48), dtype=np.float32)

    # unsharded single-device reference
    bg_plain = BatchedGraph(outer, batch_keys={key}, targets=[(gout, SlotId(0))])
    plain = np.asarray(bg_plain(**{key: (batch,)})[(gout, SlotId(0))][0])

    mesh = make_mesh(8)
    bg_sharded = BatchedGraph(
        outer, batch_keys={key}, targets=[(gout, SlotId(0))], mesh=mesh
    )
    sharded_batch = bg_sharded.shard_batch_arg(batch)
    sharded = np.asarray(bg_sharded(**{key: (sharded_batch,)})[(gout, SlotId(0))][0])

    assert np.array_equal(plain, sharded)


def test_batched_live_session():
    """Interactive batched editing: value edits re-run the cached vmapped
    program; structural edits recompile once; results track the edits."""
    import jax

    from kanter_core_tpu.parallel import BatchedLiveSession, make_mesh

    graph = NodeGraph()
    gin = graph.add_node(Node(NodeType.InputGray("in")))
    gain = graph.add_node(Node(NodeType.Value(1.0)))
    mix = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(gin, mix, SlotId(0), SlotId(0))
    graph.connect(gain, mix, SlotId(0), SlotId(1))
    graph.connect(mix, out, SlotId(0), SlotId(0))

    mesh = make_mesh(8) if len(jax.devices()) >= 8 else None
    session = BatchedLiveSession(graph, [gin], targets=[(out, SlotId(0))], mesh=mesh)

    batch = np.random.default_rng(0).random((8, 16, 16), dtype=np.float32)
    session.set_input(gin, batch)
    first = np.asarray(session.render()[(out, SlotId(0))][0])
    assert first.shape == (8, 16, 16)
    assert np.array_equal(first, batch * np.float32(1.0))

    session.set_value(gain, 0.5)
    half = np.asarray(session.render()[(out, SlotId(0))][0])
    assert np.array_equal(half, batch * np.float32(0.5))
    assert len(session._programs) == 1  # value edits reuse the program

    # structural edit: invert instead of scale
    def rewire(g):
        g.set_mix_type(mix, MixType.SUBTRACT)

    session.edit(rewire)
    session.set_value(gain, 1.0)
    inverted = np.asarray(session.render()[(out, SlotId(0))][0])
    # mix = input - gain? wiring: left=input, right=gain → input - 1.0
    assert np.array_equal(inverted, batch - np.float32(1.0))
    assert len(session._programs) == 2  # one recompile for the new structure


def test_pending_layout_is_thread_local():
    """The layout-attribution protocol (`call_with_pending_layout`) must be
    immune to a concurrent fast-path retrace on another thread writing the
    shared pending slot between a locked first-trace's record and its read
    — the jit cache keys dtype/sharding/placement beyond the shape
    signature, so a signature-hit call can still retrace. With a plain
    shared attribute (the pre-fix design) the interleaving below attributes
    the WRONG layout to the new signature and serves it forever."""
    import threading

    from kanter_core_tpu.compiler import _PendingLayout, call_with_pending_layout

    pending = _PendingLayout()
    layouts: dict = {}
    lock = threading.Lock()
    good = {"k": (0,)}

    def fn(args):
        pending.value = good
        # simulate another thread's concurrent retrace recording ITS layout
        # after ours (the race window: between our trace end and our read)
        t = threading.Thread(target=lambda: setattr(pending, "value", {"k": (1,)}))
        t.start()
        t.join()
        return ("planes",)

    result, layout = call_with_pending_layout(
        fn, {}, ("sig",), lock, layouts, pending, "no layout"
    )
    assert layout is good
    assert layouts[("sig",)] is good


def test_batched_graph_progressive_input_binding():
    """A failed or partial first call must not poison the vmapped program:
    in_axes mirror the args dict, so binding an ADDITIONAL input key later
    needs fresh axes (pre-fix, the first call's axes were cached
    unconditionally and every later call died on a pytree mismatch)."""
    import pytest

    from kanter_core_tpu.parallel import BatchedGraph

    graph = NodeGraph()
    in1 = graph.add_node(Node(NodeType.InputGray("a")))
    in2 = graph.add_node(Node(NodeType.InputGray("b")))
    mix = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(in1, mix, SlotId(0), SlotId(0))
    graph.connect(in2, mix, SlotId(0), SlotId(1))
    graph.connect(mix, out, SlotId(0), SlotId(0))

    k1, k2 = f"input_{int(in1)}", f"input_{int(in2)}"
    bg = BatchedGraph(graph, batch_keys={k1, k2}, targets=[(out, SlotId(0))])
    batch = np.random.default_rng(1).random((4, 16, 16), dtype=np.float32)

    with pytest.raises(Exception):
        bg(**{k1: (batch,)})  # in2 unbound — trace fails

    result = bg(**{k1: (batch,), k2: (batch,)})  # must recover
    plane = np.asarray(result[(out, SlotId(0))][0])
    assert np.array_equal(plane, batch + batch)


def test_batched_live_session_rows_only_mesh():
    """set_input on a spatial-only ('rows') mesh — a configuration the
    constructor accepts to keep the Pallas blur viable — must not assume a
    'batch' mesh axis exists."""
    import jax

    from kanter_core_tpu.parallel import BatchedLiveSession, make_mesh
    from kanter_core_tpu.parallel.sharded import ROW_AXIS

    if len(jax.devices()) < 8:
        pytest.skip("virtual 8-device CPU mesh required (conftest sets it up)")

    graph = NodeGraph()
    gin = graph.add_node(Node(NodeType.InputGray("in")))
    gain = graph.add_node(Node(NodeType.Value(0.25)))
    mix = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(gin, mix, SlotId(0), SlotId(0))
    graph.connect(gain, mix, SlotId(0), SlotId(1))
    graph.connect(mix, out, SlotId(0), SlotId(0))

    mesh = make_mesh(8, axes=(ROW_AXIS,))
    session = BatchedLiveSession(graph, [gin], targets=[(out, SlotId(0))], mesh=mesh)
    batch = np.random.default_rng(2).random((4, 16, 16), dtype=np.float32)
    session.set_input(gin, batch)  # 16 rows / 8 devices: row-sharded
    result = np.asarray(session.render()[(out, SlotId(0))][0])
    assert np.array_equal(result, batch * np.float32(0.25))


def test_batched_live_session_tracks_image_file(tmp_path):
    """Rewriting an Image node's file in place must refresh the served
    pixels: the program cache key stamps (size, mtime_ns) like the engine's
    recipe cache, so compile-time bindings are never served stale."""
    import os

    from PIL import Image as PILImage

    from kanter_core_tpu.parallel import BatchedLiveSession

    path = str(tmp_path / "tex.png")
    PILImage.fromarray(np.full((8, 8, 4), 64, np.uint8)).save(path)

    graph = NodeGraph()
    gin = graph.add_node(Node(NodeType.InputGray("in")))
    img = graph.add_node(Node(NodeType.Image(path)))
    sep = graph.add_node(Node(NodeType.SeparateRgba()))
    mix = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(img, sep, SlotId(0), SlotId(0))
    graph.connect(gin, mix, SlotId(0), SlotId(0))
    graph.connect(sep, mix, SlotId(0), SlotId(1))
    graph.connect(mix, out, SlotId(0), SlotId(0))

    session = BatchedLiveSession(graph, [gin], targets=[(out, SlotId(0))])
    batch = np.zeros((2, 8, 8), np.float32)
    session.set_input(gin, batch)
    first = np.asarray(session.render()[(out, SlotId(0))][0])
    assert np.allclose(first, 64.0 / 255.0)

    PILImage.fromarray(np.full((8, 8, 4), 192, np.uint8)).save(path)
    os.utime(path, ns=(1, 1))  # force a distinct mtime_ns even on fast FS
    # NO intervening edit: the render-time stamp check alone must
    # invalidate the clean-session short-circuit for a file-only change
    second = np.asarray(session.render()[(out, SlotId(0))][0])
    assert np.allclose(second, 192.0 / 255.0), "stale compile-time pixels served"
