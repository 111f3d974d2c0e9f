"""Opt-in half-precision (bfloat16) pipeline mode (DESIGN.md §9).

The default pipeline is f32 and bit-exact vs the reference goldens; bf16 is
the deployment mode for bandwidth/footprint-bound graphs. The design is
bf16 AT REST, f32 IN FLIGHT: leaves and committed planes store at bf16
(half the device-memory traffic and tier footprint), while every op
computes the same f32 math as the default pipeline. These tests
pin the contract:

- leaves and outputs are STORED at the pipeline dtype;
- in-flight math is f32: a bf16 program's output BIT-matches the f32
  pipeline run on bf16-quantized leaves, downcast at the end;
- u8 export converts from the f32 in-flight value (no storage rounding);
- plane aliasing (SeparateRgba, shared zero planes) survives the casts;
- the exact-math machinery disengages off f32 (defensive — nothing in the
  pipeline feeds it non-f32 anymore, but direct op callers may);
- f32 programs and bf16 programs never share a cache entry.
"""

import numpy as np
import pytest

from kanter_core_tpu import (
    MixType,
    Node,
    NodeGraph,
    NodeType,
    SlotId,
)
from kanter_core_tpu.compiler import CompiledGraph, compile_graph, resolve_dtype

IMAGE_2 = "/root/reference/data/image_2.png"


def _bf16():
    import jax.numpy as jnp

    return np.dtype(jnp.bfloat16)


def _full_graph():
    """Every op family: mix×5, blur, h2n, levels, separate/combine, resize
    (mismatched sizes force the resample pass), nested Graph."""
    inner = NodeGraph()
    i_in = inner.add_node(Node(NodeType.InputGray("in")))
    i_val = inner.add_node(Node(NodeType.Value(1.0)))
    i_sub = inner.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
    i_out = inner.add_node(Node(NodeType.OutputGray("out")))
    inner.connect(i_val, i_sub, SlotId(0), SlotId(0))
    inner.connect(i_in, i_sub, SlotId(0), SlotId(1))
    inner.connect(i_sub, i_out, SlotId(0), SlotId(0))

    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image(IMAGE_2)))
    val = g.add_node(Node(NodeType.Value(0.4)))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    mul = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    div = g.add_node(Node(NodeType.Mix(MixType.DIVIDE)))
    pw = g.add_node(Node(NodeType.Mix(MixType.POW)))
    add = g.add_node(Node(NodeType.Mix(MixType.ADD)))
    h2n = g.add_node(Node(NodeType.HeightToNormal()))
    blur = g.add_node(Node(NodeType.Blur(1.5)))
    lev = g.add_node(Node(NodeType.Levels(0.1, 0.9, 2.2, 0.0, 1.0)))
    gn = g.add_node(Node(NodeType.Graph(inner)))
    comb = g.add_node(Node(NodeType.CombineRgba()))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    normal_out = g.add_node(Node(NodeType.OutputRgba("normal")))
    g.connect(img, sep, SlotId(0), SlotId(0))
    g.connect(sep, mul, SlotId(0), SlotId(0))
    g.connect(val, mul, SlotId(0), SlotId(1))
    g.connect(sep, div, SlotId(1), SlotId(0))
    g.connect(val, div, SlotId(0), SlotId(1))
    g.connect(mul, pw, SlotId(0), SlotId(0))
    g.connect(div, pw, SlotId(0), SlotId(1))
    g.connect(pw, blur, SlotId(0), SlotId(0))
    g.connect(blur, lev, SlotId(0), SlotId(0))
    g.connect(lev, gn, SlotId(0), inner.input_slot_id_with_name("in"))
    g.connect(gn, add, inner.output_slot_id_with_name("out"), SlotId(0))
    g.connect(pw, add, SlotId(0), SlotId(1))
    g.connect(add, comb, SlotId(0), SlotId(0))
    g.connect(sep, comb, SlotId(2), SlotId(1))
    g.connect(comb, out, SlotId(0), SlotId(0))
    g.connect(pw, h2n, SlotId(0), SlotId(0))
    g.connect(h2n, normal_out, SlotId(0), SlotId(0))
    return g


def test_resolve_dtype():
    import jax.numpy as jnp

    assert resolve_dtype(None) == np.dtype(np.float32)
    assert resolve_dtype("float32") == np.dtype(np.float32)
    assert resolve_dtype("bfloat16") == np.dtype(jnp.bfloat16)
    assert resolve_dtype(jnp.bfloat16) == np.dtype(jnp.bfloat16)
    assert resolve_dtype(np.float32) == np.dtype(np.float32)


def test_bf16_pipeline_tracks_f32_within_rounding():
    g = _full_graph()
    r32 = CompiledGraph(g)()
    r16 = CompiledGraph(g, dtype="bfloat16")()
    assert set(r32) == set(r16)
    checked = 0
    for key in r32:
        for a, b in zip(r32[key], r16[key]):
            assert b.dtype == _bf16(), f"{key} stored at {b.dtype}"
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape
            # bf16 eps is 2^-8; chains amplify a little. The h2n normal map
            # divides near-zero gradients so give it the loosest bound.
            assert float(np.nanmax(np.abs(a - b))) < 0.125
            checked += 1
    assert checked >= 5


def test_bf16_u8_export_within_a_few_lsb():
    g = _full_graph()
    targets = None
    u32 = CompiledGraph(g, targets, include_u8=True)()
    u16 = CompiledGraph(g, targets, include_u8=True, dtype="bfloat16")()
    for key in u32:
        a = np.asarray(u32[key], np.int32)
        b = np.asarray(u16[key], np.int32)
        assert b.dtype == np.int32 and a.shape == b.shape
        # bf16 has 8 mantissa bits over [0.5, 1) → ≤ 1 LSB of u8 per
        # rounding; the chain compounds a few. The h2n output divides
        # near-zero gradients, so allow it the most slack.
        assert int(np.max(np.abs(a - b))) <= 24


def test_bf16_default_pipeline_untouched():
    """dtype=None must change NOTHING: the f32 program's planes are f32 and
    golden-exact paths flow through the same code."""
    g = _full_graph()
    prog = CompiledGraph(g)
    assert prog.dtype == np.dtype(np.float32)
    for key, planes in prog().items():
        for p in planes:
            assert p.dtype == np.float32


def test_bf16_emit_all_preserves_aliasing():
    """SeparateRgba outputs must still alias the Image leaf's planes (one
    unique device plane each), and the layout must match the f32 run's."""
    g = NodeGraph()
    img = g.add_node(Node(NodeType.Image(IMAGE_2)))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(img, sep, SlotId(0), SlotId(0))
    g.connect(sep, out, SlotId(1), SlotId(0))

    p32 = CompiledGraph(g, emit_all=True)
    p16 = CompiledGraph(g, emit_all=True, dtype="bfloat16")
    u32, l32 = p32.call_with_layout()
    u16, l16 = p16.call_with_layout()
    assert l16 == l32  # same aliasing structure
    assert len(u16) == len(u32)
    for p in u16:
        assert p.dtype == _bf16()


def test_bf16_combine_shared_zero_plane_stays_shared():
    """CombineRgba's lazily-shared zero plane must stay ONE plane after the
    storage downcast (the aliasing-safe `store` memo in CompiledGraph's
    program body keys on tracer identity, so shared planes downcast once)."""
    g = NodeGraph()
    val = g.add_node(Node(NodeType.Value(0.25)))
    comb = g.add_node(Node(NodeType.CombineRgba()))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(val, comb, SlotId(0), SlotId(0))  # G/B unconnected → shared zero
    g.connect(comb, out, SlotId(0), SlotId(0))

    prog = CompiledGraph(g, emit_all=True, dtype="bfloat16")
    unique, layout = prog.call_with_layout()
    idxs = layout[(out, SlotId(0))]
    assert idxs[1] == idxs[2], "G and B zero planes no longer alias"


def test_bf16_program_cache_is_dtype_keyed():
    g = _full_graph()
    p32 = compile_graph(g)
    p16 = compile_graph(g, dtype="bfloat16")
    p16b = compile_graph(g, dtype="bfloat16")
    assert p32._fn is not p16._fn
    assert p16._fn is p16b._fn  # cache hit within the dtype


def test_exact_math_disengages_off_f32():
    import jax.numpy as jnp

    from kanter_core_tpu.ops.exact_math import (
        corrected_div,
        corrected_sqrt,
        ds_pow,
        nc_mul,
    )

    x = jnp.asarray([[0.5, 0.25]], jnp.bfloat16)
    y = jnp.asarray([[0.75, 3.0]], jnp.bfloat16)
    for fn, ref in (
        (nc_mul, lambda a, b: a * b),
        (corrected_div, lambda a, b: a / b),
        (ds_pow, jnp.power),
    ):
        got = fn(x, y)
        assert got.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(got, np.float32), np.asarray(ref(x, y), np.float32))
    s = corrected_sqrt(x)
    assert s.dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(s, np.float32), np.asarray(jnp.sqrt(x), np.float32))
    # and f32 still takes the corrected paths (value check: div correction
    # returns the correctly-rounded quotient, sqrt stays exact)
    xf = jnp.asarray([[1.0, 2.0]], jnp.float32)
    yf = jnp.asarray([[3.0, 7.0]], jnp.float32)
    assert corrected_div(xf, yf).dtype == jnp.float32


def test_bf16_batched_graph():
    import jax

    from kanter_core_tpu.parallel import BatchedGraph

    g = NodeGraph()
    gin = g.add_node(Node(NodeType.InputGray("in")))
    gain = g.add_node(Node(NodeType.Value(0.5)))
    mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(gin, mix, SlotId(0), SlotId(0))
    g.connect(gain, mix, SlotId(0), SlotId(1))
    g.connect(mix, out, SlotId(0), SlotId(0))

    key = f"input_{int(gin)}"
    bg = BatchedGraph(g, batch_keys={key}, targets=[(out, SlotId(0))], dtype="bfloat16")
    batch = np.linspace(0, 1, 4 * 16 * 16, dtype=np.float32).reshape(4, 16, 16)
    batch16 = np.asarray(batch, _bf16())
    result = bg(**{key: (jax.numpy.asarray(batch16),)})
    plane = result[(out, SlotId(0))][0]
    assert plane.dtype == _bf16()
    expect = np.asarray(np.asarray(batch16, np.float32) * np.float32(0.5), _bf16())
    assert np.array_equal(
        np.asarray(plane, np.float32), np.asarray(expect, np.float32)
    )


def test_bf16_batched_live_session():
    from kanter_core_tpu.parallel import BatchedLiveSession

    g = NodeGraph()
    gin = g.add_node(Node(NodeType.InputGray("in")))
    gain = g.add_node(Node(NodeType.Value(0.25)))
    mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(gin, mix, SlotId(0), SlotId(0))
    g.connect(gain, mix, SlotId(0), SlotId(1))
    g.connect(mix, out, SlotId(0), SlotId(0))

    session = BatchedLiveSession(g, [gin], targets=[(out, SlotId(0))], dtype="bfloat16")
    batch = np.random.default_rng(3).random((2, 8, 8), dtype=np.float32)
    session.set_input(gin, batch)
    plane = session.render()[(out, SlotId(0))][0]
    assert plane.dtype == _bf16()
    got = np.asarray(plane, np.float32)
    expect = np.asarray(
        np.asarray(np.asarray(batch, _bf16()), np.float32) * np.float32(0.25), _bf16()
    ).astype(np.float32)
    assert np.array_equal(got, expect)


# --- engine-level precision (TextureProcessor(precision="bfloat16")) ---


def _engine_graph(lg_writer):
    with lg_writer as g:
        img = g.add_node(Node(NodeType.Image(IMAGE_2)))
        sep = g.add_node(Node(NodeType.SeparateRgba()))
        val = g.add_node(Node(NodeType.Value(0.3)))
        mul = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        blur = g.add_node(Node(NodeType.Blur(1.2)))
        comb = g.add_node(Node(NodeType.CombineRgba()))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(img, sep, SlotId(0), SlotId(0))
        g.connect(sep, mul, SlotId(0), SlotId(0))
        g.connect(val, mul, SlotId(0), SlotId(1))
        g.connect(mul, blur, SlotId(0), SlotId(0))
        g.connect(blur, comb, SlotId(0), SlotId(0))
        g.connect(sep, comb, SlotId(2), SlotId(1))
        g.connect(comb, out, SlotId(0), SlotId(0))
    return out


def _render_u8(precision=None, fuse=True):
    from kanter_core_tpu import TextureProcessor

    with TextureProcessor(200_000_000, precision=precision) as tp:
        lg = tp.new_live_graph()
        if not fuse:
            with lg.write() as g:
                g.fuse_subgraphs = False
        out = _engine_graph(lg.write())
        data = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
        sd = lg.slot_data(out, SlotId(0))
        dtypes = [p.dtype.name for p in sd.image.planes]
        nbytes = sd.image.planes[0].bytes()
    return np.asarray(data), dtypes, nbytes


def test_engine_bf16_commits_half_size_planes():
    u32, d32, n32 = _render_u8()
    u16, d16, n16 = _render_u8(precision="bfloat16")
    assert d32 == ["float32"] * 4
    assert d16 == ["bfloat16"] * 4
    assert n16 * 2 == n32
    diff = np.abs(u32.astype(np.int32) - u16.astype(np.int32))
    assert int(diff.max()) <= 4


def test_engine_bf16_per_node_path():
    """With fusion disabled the eager per-node path must also commit at the
    pipeline dtype (ops.process_node's `_to_precision`)."""
    u32, _, _ = _render_u8(fuse=False)
    u16, d16, n16 = _render_u8(precision="bfloat16", fuse=False)
    assert d16 == ["bfloat16"] * 4
    diff = np.abs(u32.astype(np.int32) - u16.astype(np.int32))
    assert int(diff.max()) <= 4


def test_engine_bf16_fused_route_bitmatches_library_program():
    """The fused ENGINE route must quantize Image leaves at bf16 exactly
    like the library CompiledGraph(dtype=bf16) path: same bf16 leaves →
    f32 in flight → one output downcast, so the committed planes BIT-match.
    Regression: the engine's per-dispatch image re-decode
    (`collect_image_bindings`) used to re-upload leaves at f32, silently
    overriding the program's bf16 bindings — the fused result then computed
    from UNQUANTIZED leaves (and moved 2x the bytes)."""
    from kanter_core_tpu import TextureProcessor

    def build(g):
        img = g.add_node(Node(NodeType.Image(IMAGE_2)))
        sep = g.add_node(Node(NodeType.SeparateRgba()))
        val = g.add_node(Node(NodeType.Value(0.3)))
        mul = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        blur = g.add_node(Node(NodeType.Blur(1.2)))
        comb = g.add_node(Node(NodeType.CombineRgba()))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(img, sep, SlotId(0), SlotId(0))
        g.connect(sep, mul, SlotId(0), SlotId(0))
        g.connect(val, mul, SlotId(0), SlotId(1))
        g.connect(mul, blur, SlotId(0), SlotId(0))
        g.connect(blur, comb, SlotId(0), SlotId(0))
        g.connect(sep, comb, SlotId(2), SlotId(1))
        g.connect(comb, out, SlotId(0), SlotId(0))
        return out

    lib_graph = NodeGraph()
    lib_out = build(lib_graph)
    prog = CompiledGraph(
        lib_graph, targets=[(lib_out, SlotId(0))], dtype="bfloat16"
    )
    lib_planes = [np.asarray(p) for p in prog()[(lib_out, SlotId(0))]]

    with TextureProcessor(200_000_000, precision="bfloat16") as tp:
        lg = tp.new_live_graph()
        with lg.write() as g:
            out = build(g)
        TextureProcessor.buffer_rgba(lg, out, SlotId(0))
        eng_planes = [
            np.asarray(p.host_data())
            for p in lg.slot_data(out, SlotId(0)).image.planes
        ]

    assert all(p.dtype == _bf16() for p in lib_planes)
    for i, (a, b) in enumerate(zip(eng_planes, lib_planes)):
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16)), (
            f"plane {i}: fused engine route diverged from the library bf16 "
            f"program — image leaves not quantized identically"
        )


def test_bf16_plane_buffer_tiers_roundtrip():
    """A bf16 plane must survive DEVICE→HOST→STORAGE→DEVICE bit-exactly
    (spill hash + reload dtype, transient_buffer.py)."""
    import jax.numpy as jnp

    from kanter_core_tpu.transient_buffer import plane_from_device

    src = np.arange(64 * 64, dtype=np.float32).reshape(64, 64) / 4096.0
    plane = plane_from_device(jnp.asarray(src, jnp.bfloat16))
    assert plane.dtype.name == "bfloat16"
    assert plane.bytes() == 64 * 64 * 2
    before = np.asarray(plane.host_data(), np.float32)
    assert plane.evict_to_host()
    assert plane.spill_to_storage()
    after = np.asarray(plane.data(), np.float32)  # faults back in
    assert plane.dtype.name == "bfloat16"
    assert np.array_equal(before, after)


def test_bf16_checkpoint_roundtrip(tmp_path):
    """Checkpointing a bf16 session stores planes bit-exactly (uint16 view +
    dtype tag) and resume serves the same u8 output with no recompute."""
    from kanter_core_tpu import TextureProcessor
    from kanter_core_tpu.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "session.ckpt")
    with TextureProcessor(200_000_000, precision="bfloat16") as tp:
        lg = tp.new_live_graph()
        out = _engine_graph(lg.write())
        first = np.asarray(TextureProcessor.buffer_rgba(lg, out, SlotId(0)))
        save_checkpoint(lg, path)

    with TextureProcessor(200_000_000, precision="bfloat16") as tp2:
        lg2 = load_checkpoint(tp2, path)
        sd = lg2.slot_data(out, SlotId(0))
        assert [p.dtype.name for p in sd.image.planes] == ["bfloat16"] * 4
        second = np.asarray(TextureProcessor.buffer_rgba(lg2, out, SlotId(0)))
    assert np.array_equal(first, second)


def test_engine_bf16_capacity_path_interops():
    """Under a tile budget the banded path evaluates in f32 (capacity is
    correctness-first): results commit f32 and values stay close to the
    all-dense bf16 run."""
    from kanter_core_tpu import TextureProcessor

    with TextureProcessor(
        200_000_000, precision="bfloat16", tile_bytes=64 * 1024
    ) as tp:
        lg = tp.new_live_graph()
        out = _engine_graph(lg.write())
        banded = np.asarray(TextureProcessor.buffer_rgba(lg, out, SlotId(0)))
        sd = lg.slot_data(out, SlotId(0))
        assert {p.dtype.name for p in sd.image.planes} == {"float32"}

    dense, _, _ = _render_u8(precision="bfloat16")
    diff = np.abs(banded.astype(np.int32) - dense.astype(np.int32))
    assert int(diff.max()) <= 4


def test_bf16_in_flight_math_bitmatches_f32_on_quantized_leaves():
    """THE semantic contract of the mode: a bf16 program is exactly the f32
    pipeline run on bf16-quantized leaves with one downcast at the end —
    bit-for-bit (in-flight math is f32, so exact-math stays engaged)."""
    import jax.numpy as jnp

    g = NodeGraph()
    gin = g.add_node(Node(NodeType.InputGray("in")))
    gin2 = g.add_node(Node(NodeType.InputGray("in2")))
    val = g.add_node(Node(NodeType.Value(0.37)))
    mul = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    div = g.add_node(Node(NodeType.Mix(MixType.DIVIDE)))
    pw = g.add_node(Node(NodeType.Mix(MixType.POW)))
    blur = g.add_node(Node(NodeType.Blur(1.0)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(gin, mul, SlotId(0), SlotId(0))
    g.connect(val, mul, SlotId(0), SlotId(1))
    g.connect(gin2, div, SlotId(0), SlotId(0))
    g.connect(val, div, SlotId(0), SlotId(1))
    g.connect(mul, pw, SlotId(0), SlotId(0))
    g.connect(div, pw, SlotId(0), SlotId(1))
    g.connect(pw, blur, SlotId(0), SlotId(0))
    g.connect(blur, out, SlotId(0), SlotId(0))

    rng = np.random.default_rng(7)
    a = rng.random((32, 32), dtype=np.float32)
    b = rng.random((32, 32), dtype=np.float32)

    prog16 = CompiledGraph(g, targets=[(out, SlotId(0))], dtype="bfloat16")
    prog16.bind_input(gin, [a])
    prog16.bind_input(gin2, [b])
    got = np.asarray(prog16()[(out, SlotId(0))][0])
    assert got.dtype == _bf16()

    # reference: quantize leaves to bf16, upcast, run the F32 program,
    # downcast the result once
    qa = np.asarray(np.asarray(a, _bf16()), np.float32)
    qb = np.asarray(np.asarray(b, _bf16()), np.float32)
    prog32 = CompiledGraph(g, targets=[(out, SlotId(0))])
    prog32.bind_input(gin, [qa])
    prog32.bind_input(gin2, [qb])
    expect = np.asarray(
        jnp.asarray(prog32()[(out, SlotId(0))][0]).astype(jnp.bfloat16)
    )
    assert np.array_equal(got.view(np.uint16), expect.view(np.uint16)), (
        "bf16 program diverged from f32-in-flight semantics"
    )


def test_bf16_u8_export_converts_from_f32_in_flight():
    """include_u8 exports quantize the f32 in-flight value, not the bf16
    stored value: on a graph whose leaves are already bf16-exact the u8
    output must BIT-match the f32 program's."""
    g = NodeGraph()
    gin = g.add_node(Node(NodeType.InputGray("in")))
    val = g.add_node(Node(NodeType.Value(0.5)))
    mul = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    out = g.add_node(Node(NodeType.OutputGray("out")))
    g.connect(gin, mul, SlotId(0), SlotId(0))
    g.connect(val, mul, SlotId(0), SlotId(1))
    g.connect(mul, out, SlotId(0), SlotId(0))

    # leaves exactly representable in bf16 → quantization is identity
    a = (np.arange(16 * 16, dtype=np.float32).reshape(16, 16) % 128) / 128.0
    p16 = CompiledGraph(g, targets=[(out, SlotId(0))], include_u8=True, dtype="bfloat16")
    p32 = CompiledGraph(g, targets=[(out, SlotId(0))], include_u8=True)
    p16.bind_input(gin, [a])
    p32.bind_input(gin, [a])
    u16 = np.asarray(p16()[(out, SlotId(0))])
    u32 = np.asarray(p32()[(out, SlotId(0))])
    assert np.array_equal(u16, u32)


def test_engine_bf16_composes_with_mesh():
    """precision="bfloat16" × mesh: the fused dispatch row-shards bf16
    leaves/commits over the mesh and the result matches the single-device
    bf16 run byte-for-byte at the u8 boundary."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from kanter_core_tpu import TextureProcessor

    devices = jax.devices()
    if len(devices) < 8:
        import pytest

        pytest.skip("needs the 8 virtual devices from conftest")
    mesh = Mesh(np.asarray(devices[:8]), ("rows",))

    u_single, d_single, _ = _render_u8(precision="bfloat16")

    with TextureProcessor(200_000_000, precision="bfloat16", mesh=mesh) as tp:
        lg = tp.new_live_graph()
        out = _engine_graph(lg.write())
        u_mesh = np.asarray(TextureProcessor.buffer_rgba(lg, out, SlotId(0)))
        sd = lg.slot_data(out, SlotId(0))
        assert [p.dtype.name for p in sd.image.planes] == ["bfloat16"] * 4
        committed = sd.image.planes[0].data()
        assert getattr(committed.sharding, "mesh", None) is not None

    assert d_single == ["bfloat16"] * 4
    assert np.array_equal(u_mesh, u_single), (
        "bf16 + mesh diverged from single-device bf16"
    )
