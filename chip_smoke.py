"""Smoke test of the texture engine on one GPU (or, with --chips 4, four).

Drives the system's main path through the entry points a user calls —
`TextureProcessor` → `LiveGraph` → engine → fused program — at 4096² with
the flagship composition (every op family in one fused program), then
checks each hand-written kernel against its plain `jnp` form on the card,
runs the device parity battery against a CPU-only child process, and runs
the tests marked for the card. Inputs are made from a seed.

    python chip_smoke.py              # one card: phases 1-6
    python chip_smoke.py --chips 4    # four cards: the mesh phase alone

The last line of standard output is one JSON object,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`,
printed only when every phase passed. Without a GPU the script says so and
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

CANVAS = 4096
SEED = 0


def card_name_and_limit() -> str:
    """`nvidia-smi`'s name and power limit (a child process; no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


class Compiles:
    """Counts XLA backend compiles (JAX's compile-duration event)."""

    def __init__(self):
        import jax

        self.n = 0

        def listener(event, duration, **kwargs):
            if event == "/jax/core/compile/backend_compile_duration":
                self.n += 1

        jax.monitoring.register_event_duration_secs_listener(listener)


def seeded_planes(n, size, seed=SEED):
    rng = np.random.default_rng(seed)
    return [rng.random((size, size), dtype=np.float32) for _ in range(n)]


def timed(fn, *args, reps=10):
    """(median seconds, result) of `fn(*args)` ending in block_until_ready,
    after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


# --- phase 1 -----------------------------------------------------------------

def phase_device(card):
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"devices: {devs}")
    print(f"platform={d.platform} kind={d.device_kind} count={len(devs)} jax={jax.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"card: {card}")
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {d.platform} ({d.device_kind}); "
                         "this smoke test needs an NVIDIA card and has no CPU fallback")
    return d


# --- phase 2 -----------------------------------------------------------------

def phase_numerics():
    import jax

    from kanter_core_tpu.ops.exact_math import numerics
    from kanter_core_tpu.parity import probe_numerics

    measured = probe_numerics()
    expected = numerics(jax.default_backend())
    print(f"numerics measured: {measured}")
    print(f"numerics table:    {expected}")
    assert measured == expected, "the backend's numerics differ from its NUMERICS row"


# --- phase 3 -----------------------------------------------------------------

def _flagship_session(tp, canvas, planes):
    from kanter_core_tpu import SlotId
    from kanter_core_tpu.graphs import flagship_graph
    from kanter_core_tpu.slot_data import SlotData
    from kanter_core_tpu.slot_image import SlotImage

    graph, inputs, out = flagship_graph(canvas)
    lg = tp.new_live_graph()
    with lg.write() as g:
        g.set_node_graph(graph)
        for node, plane in zip(inputs, planes):
            g.add_input_slot_data(SlotData(node, SlotId(0), SlotImage.Gray(plane)))
    return lg, out


def phase_main_path(card, canvas=CANVAS):
    import jax

    from kanter_core_tpu import NodeType, NodeTypeKind, Side, SlotId, TextureProcessor

    compiles = Compiles()
    planes = seeded_planes(4, canvas)
    read = TextureProcessor.buffer_rgba
    with TextureProcessor(1 << 40) as tp:
        lg, out = _flagship_session(tp, canvas, planes)
        t0 = time.perf_counter()
        base = read(lg, out, SlotId(0))
        t_first = time.perf_counter() - t0
        assert base.dtype == np.uint8 and base.size == canvas * canvas * 4, base.shape
        assert len(np.unique(base.reshape(-1, 4)[:, :3])) > 1, "flagship output is constant"
        print(f"render {canvas}^2 first (compile + run): {t_first:.3f} s, "
              f"{compiles.n} compiles [{card}]")

        with lg.read() as g:
            value = next(n for n in g.node_ids()
                         if g.node(n).node_type.kind == NodeTypeKind.VALUE
                         and float(g.node(n).node_type.payload) != 1.0)
        n0 = compiles.n
        t0 = time.perf_counter()
        with lg.write() as g:
            g.node_mut(value).node_type = NodeType.Value(0.93)
        edited = read(lg, out, SlotId(0))
        t_edit = time.perf_counter() - t0
        assert not np.array_equal(edited, base), "a Value edit did not change the pixels"
        with lg.write() as g:
            g.node_mut(value).node_type = NodeType.Value(0.96)
        t0 = time.perf_counter()
        assert np.array_equal(read(lg, out, SlotId(0)), base), "Value edit + revert changed pixels"
        t_revert = time.perf_counter() - t0
        print(f"value edit → pixels: {t_edit:.3f} s; revert: {t_revert:.3f} s; "
              f"{compiles.n - n0} compiles [{card}]")

        with lg.read() as g:
            warp = next(n for n in g.node_ids()
                        if g.node(n).node_type.kind == NodeTypeKind.WARP)
            (edge,) = g.connected_edges(warp, Side.INPUT, SlotId(1))
        t0 = time.perf_counter()
        with lg.write() as g:
            g.disconnect_slot(warp, Side.INPUT, SlotId(1))
        unwarped = read(lg, out, SlotId(0))
        t_struct = time.perf_counter() - t0
        assert not np.array_equal(unwarped, base), "disconnecting the warp map changed nothing"
        with lg.write() as g:
            g.connect(edge.output_id, warp, edge.output_slot, SlotId(1))
        assert np.array_equal(read(lg, out, SlotId(0)), base), "reconnect did not restore pixels"
        with lg.write() as g:
            assert g.undo()
        assert np.array_equal(read(lg, out, SlotId(0)), unwarped), "undo did not restore pixels"
        print(f"structural edit → pixels: {t_struct:.3f} s; reconnect and undo verified [{card}]")
        stats = jax.devices()[0].memory_stats() or {}
        print(f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
              f"bytes_limit={stats.get('bytes_limit')} "
              f"engine programs={tp.metrics()['fused_programs']} [{card}]")

    # spill: device and host budgets below the working set, so the memory
    # manager moves planes device → host → disk; the read faults them back
    budget = 2 * canvas * canvas * 4
    with TextureProcessor(budget, host_memory_threshold=budget) as tp:
        lg, out = _flagship_session(tp, canvas, planes)
        t0 = time.perf_counter()
        first = read(lg, out, SlotId(0))
        t_spill = time.perf_counter() - t0
        deadline = time.perf_counter() + 120
        while tp.metrics()["bytes_storage"] == 0 and time.perf_counter() < deadline:
            time.sleep(0.05)
        m = tp.metrics()
        print(f"budgeted render: {t_spill:.3f} s; tiers device={m['bytes_device']} "
              f"host={m['bytes_host']} disk={m['bytes_storage']} [{card}]")
        assert m["bytes_storage"] > 0, "nothing spilled to disk"
        t0 = time.perf_counter()
        spilled = read(lg, out, SlotId(0))
        print(f"read back from the spill tiers: {time.perf_counter() - t0:.3f} s [{card}]")
        assert np.array_equal(first, base), "budgeted render differs from the unconstrained one"
        assert np.array_equal(spilled, base), "spilled planes came back different"


# --- phase 4 -----------------------------------------------------------------

def phase_kernels(card, canvas=CANVAS):
    import jax
    import jax.numpy as jnp

    from kanter_core_tpu.ops.blur import _blur_axis0, gaussian_taps
    from kanter_core_tpu.ops.blur_triton import blur_triton

    planes = [jax.device_put(p) for p in seeded_planes(4, canvas, seed=SEED + 1)]
    for sigma, n_planes in ((1.0, 1), (5.0, 1), (20.0, 1), (1.2, 4), (5.0, 4)):
        taps_np = gaussian_taps(sigma)
        taps = tuple(float(w) for w in taps_np)

        def jnp_form(*ps):
            return [_blur_axis0(_blur_axis0(p, taps_np).T, taps_np).T for p in ps]

        def kernel_form(*ps):
            return [blur_triton(p, taps) for p in ps]

        args = planes[:n_planes]
        t_jnp, ref = timed(jax.jit(jnp_form), *args)
        t_ker, got = timed(jax.jit(kernel_form), *args)
        ok = all(same_bits(a, b) for a, b in zip(ref, got))
        # the least bytes: read and write each plane once per pass
        ideal = 2 * 2 * n_planes * canvas * canvas * 4
        print(f"blur {canvas}^2 x{n_planes} sigma={sigma} taps={len(taps)}: "
              f"jnp {t_jnp * 1e3:.3f} ms, triton {t_ker * 1e3:.3f} ms, "
              f"bit-identical={ok}, triton {ideal / t_ker / 1e9:.0f} GB/s of "
              f"two-pass traffic [{card}]")
        assert ok, f"blur kernel differs from the jnp form at sigma={sigma}"

    # the flagship's fused program with and without the kernel blur
    from kanter_core_tpu import SlotId
    from kanter_core_tpu.compiler import CompiledGraph
    from kanter_core_tpu.graphs import flagship_graph

    graph, inputs, out = flagship_graph(canvas)
    outs = {}
    for pallas_ok in (False, True):
        prog = CompiledGraph(graph, targets=[(out, SlotId(0))], pallas_ok=pallas_ok)
        for node, p in zip(inputs, planes):
            prog.bind_input(node, [p])
        t, res = timed(prog, reps=5)
        outs[pallas_ok] = res[(out, SlotId(0))]
        print(f"flagship fused program {canvas}^2, {'triton' if pallas_ok else 'jnp'} "
              f"blur: {t * 1e3:.3f} ms [{card}]")
    assert all(same_bits(a, b) for a, b in zip(outs[False], outs[True]))

    # the two plain-XLA replacements of removed kernels, for the record
    from kanter_core_tpu.ops.distance import _jfa_steps, distance_plane
    from kanter_core_tpu.ops.warp import warp_bindings, warp_planes

    k = warp_bindings((37.0, 5.0))["k"]
    idx = np.arange(canvas, dtype=np.int32)
    for n_planes in (1, 4):
        fn = jax.jit(lambda ps, m: warp_planes(ps, m, idx, idx, k, canvas, canvas))
        t, _ = timed(fn, tuple(planes[:n_planes]), planes[0])
        ideal = (2 * n_planes + 1) * canvas * canvas * 4
        print(f"warp gather {canvas}^2 x{n_planes}: {t * 1e3:.3f} ms, "
              f"{ideal / t / 1e9:.0f} GB/s of read-once traffic [{card}]")
    mask = jnp.asarray(planes[1] > 0.999, jnp.float32)
    t, _ = timed(jax.jit(distance_plane), mask, np.float32(64.0), reps=5)
    steps = len(_jfa_steps(canvas, canvas))
    print(f"distance {canvas}^2: {t * 1e3:.3f} ms, {steps} steps, "
          f"{t / steps * 1e3:.3f} ms/step [{card}]")


# --- phase 5 -----------------------------------------------------------------

def phase_parity(card, reference, flagship_canvas=None):
    """`reference` = (child process, npz path) from `parity.start_reference`,
    started before the card phases so the CPU side runs beside them."""
    from kanter_core_tpu import parity

    t0 = time.perf_counter()
    kw = {} if flagship_canvas is None else {"flagship_canvas": flagship_canvas}
    rows = parity.finish_battery(*reference, **kw)
    bad = []
    for name, stats, allowed in rows:
        ok = parity.row_ok(stats, allowed)
        if stats["diffs"] or not ok:
            print(f"{'OK  ' if ok else 'DIFF'} {name} {stats} allowed={allowed}")
        if not ok:
            bad.append(name)
    print(f"parity: {len(rows) - len(bad)}/{len(rows)} rows within bounds vs XLA:CPU "
          f"({time.perf_counter() - t0:.1f} s after the card phases) [{card}]")
    assert not bad, f"parity rows out of bounds: {bad}"


# --- phase 6 -----------------------------------------------------------------

def phase_card_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["KANTER_TEST_DEVICE"] = "gpu"  # conftest keeps the card
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    assert rc == 0, f"card tests failed (pytest exit code {rc})"


# --- phase 7 -----------------------------------------------------------------

def _u8_of(planes):
    """The engine's u8 export of f32 output planes (`SlotImage.to_u8`)."""
    from kanter_core_tpu.slot_image import SlotImage
    from kanter_core_tpu.transient_buffer import plane_from_device

    return SlotImage([plane_from_device(p) for p in planes]).to_u8()


def phase_four_cards(card, canvas=None, batch=8, batch_canvas=CANVAS):
    import jax
    from jax.sharding import Mesh

    from kanter_core_tpu import SlotId, TextureProcessor
    from kanter_core_tpu.compiler import CompiledGraph
    from kanter_core_tpu.graphs import flagship_graph
    from kanter_core_tpu.parallel import BatchedLiveSession

    devices = jax.devices()
    assert len(devices) >= 4, f"need 4 devices, have {len(devices)}"
    mesh = Mesh(np.asarray(devices[:4]), ("rows",))

    # the one-card reference: the flagship's fused program on card 0, at
    # 8192² when its compiled memory fits one card, else 4096²
    for size in ((8192, CANVAS) if canvas is None else (canvas,)):
        graph, inputs, out = flagship_graph(size)
        planes = seeded_planes(4, size)
        ref = CompiledGraph(graph, targets=[(out, SlotId(0))])
        for node, p in zip(inputs, planes):
            ref.bind_input(node, [p])
        compiled = ref._fn.lower(dict(ref._bindings)).compile()
        mem = compiled.memory_analysis()
        need = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                + mem.output_size_in_bytes) if mem is not None else 0
        limit = (devices[0].memory_stats() or {}).get("bytes_limit", 0)
        print(f"one-card {size}^2 flagship program needs {need} B of {limit} B")
        if limit == 0 or need < limit:
            break
    print(f"four-card flagship canvas: {size}^2")
    t0 = time.perf_counter()
    ref_u8 = _u8_of(compiled(dict(ref._bindings))[(out, SlotId(0))])
    print(f"one-card reference {size}^2: {time.perf_counter() - t0:.3f} s [{card}]")
    with TextureProcessor(1 << 40, mesh=mesh) as tp:
        lg, lg_out = _flagship_session(tp, size, planes)
        t0 = time.perf_counter()
        mesh_u8 = TextureProcessor.buffer_rgba(lg, lg_out, SlotId(0))
        print(f"flagship {size}^2 on the 4-card row mesh: {time.perf_counter() - t0:.3f} s "
              f"(first render, compile included) [{card}]")
    assert np.array_equal(mesh_u8, ref_u8), "4-card mesh render differs from one card"
    print(f"flagship {size}^2: 4-card mesh u8 == one-card u8")
    del ref, compiled

    graph, inputs, out = flagship_graph(batch_canvas)
    bmesh = Mesh(np.asarray(devices[:4]), ("batch",))
    session = BatchedLiveSession(graph, inputs, targets=[(out, SlotId(0))], mesh=bmesh)
    rng = np.random.default_rng(SEED + 2)
    stacks = [rng.random((batch, batch_canvas, batch_canvas), dtype=np.float32)
              for _ in inputs]
    for node, stack in zip(inputs, stacks):
        session.set_input(node, stack)
    t0 = time.perf_counter()
    result = jax.block_until_ready(session.render()[(out, SlotId(0))])
    print(f"BatchedLiveSession {batch}x{batch_canvas}^2 over 4 cards: "
          f"{time.perf_counter() - t0:.3f} s (first render) [{card}]")
    single = CompiledGraph(graph, targets=[(out, SlotId(0))])
    for b in range(batch):
        for node, stack in zip(inputs, stacks):
            single.bind_input(node, [stack[b]])
        one = single()[(out, SlotId(0))]
        assert all(same_bits(np.asarray(r[b]), q) for r, q in zip(result, one)), \
            f"batched canvas {b} differs from its one-card render"
    print(f"BatchedLiveSession: all {batch} canvases bit-identical to one-card renders")


def run(phases) -> bool:
    failed = []
    for name, fn in phases:
        print(f"=== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report every phase, then fail the run
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            print(f"=== {name}: FAILED", flush=True)
        else:
            print(f"=== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"failed phases: {failed}", flush=True)
    return not failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh phase")
    args = ap.parse_args(argv)

    card = card_name_and_limit()
    import jax

    import kanter_core_tpu  # noqa: F401 — a missing package fails the run here

    device = phase_device(card)
    if args.chips == 4:
        ok = run([("4 cards: mesh flagship and batched session",
                   lambda: phase_four_cards(card))])
    else:
        from kanter_core_tpu import parity

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cpu_ref.npz")
            child = parity.start_reference(path)  # XLA:CPU only, beside the card
            try:
                ok = run([
                    ("numerics probe", phase_numerics),
                    (f"main path at {CANVAS}^2", lambda: phase_main_path(card)),
                    ("kernels vs jnp", lambda: phase_kernels(card)),
                    ("parity vs XLA:CPU", lambda: phase_parity(card, (child, path))),
                    ("card-only tests", phase_card_tests),
                ])
            finally:
                if child.poll() is None:
                    child.kill()
                child.wait()
    if not ok:
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
