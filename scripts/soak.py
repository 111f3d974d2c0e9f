"""Randomized interactive soak: apply random edit batches to a live graph,
render through the engine, and validate every render against a freshly
compiled (uncached) evaluation of the same topology — the engine's dirty
tracking, fusion, memoization, cancellation, and eviction must never change
pixels.

Run: python scripts/soak.py [iters] [seed]
Backend: whatever JAX picks (`JAX_PLATFORMS=cpu` for the CPU); both the
engine render and the ground-truth evaluation run on the same backend, so
equality is meaningful either way."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from kanter_core_tpu import (
    LiveGraph,
    MixType,
    Node,
    NodeType,
    ResizePolicy,
    Side,
    Size,
    SlotId,
    SlotType,
    TextureProcessor,
)
from kanter_core_tpu.compiler import CompiledGraph

ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 120
SEED = int(sys.argv[2]) if len(sys.argv) > 2 else 0


def main():
    rng = np.random.default_rng(SEED)
    # the soaks rotate the engine route: dense fused, blockwise tiled
    # (tile_bytes=1: every partition exceeds the budget), shape-bucketed,
    # and the bf16 pipeline — each must stay live and correct under the
    # same randomized edit/cancel/eviction churn
    mode = rng.integers(4)
    tile_bytes = 1 if mode == 1 else None
    bucket_sizes = mode == 2  # shape-bucketed engine route
    precision = "bfloat16" if mode == 3 else None
    tp = TextureProcessor(
        memory_threshold=int(rng.integers(64, 4096)), tile_bytes=tile_bytes,
        bucket_sizes=bucket_sizes, precision=precision,
    )
    try:
        _main_loop(tp, rng, tile_bytes, bucket_sizes, precision)
    finally:
        # ALWAYS join the daemons before the interpreter exits — a failure
        # SystemExit with the eviction manager mid device-transfer aborts
        # the process from C++ ("FATAL: exception not rethrown", rc=134,
        # CLAUDE.md), replacing the seed/iteration diagnostic with noise
        tp.shutdown_now()


def _main_loop(tp, rng, tile_bytes, bucket_sizes, precision):
    lg = tp.new_live_graph()

    values, mixes, combines = [], [], []
    with lg.write() as g:
        g.use_cache = bool(rng.integers(2))
        g.fuse_subgraphs = bool(rng.integers(2))
        g.memoize = bool(rng.integers(2))
        print(f"mode: fuse={g.fuse_subgraphs} memoize={g.memoize} "
              f"use_cache={g.use_cache} tiled={tile_bytes is not None} "
              f"bucketed={bucket_sizes} precision={precision or 'float32'}")
        for v in range(4):
            values.append(g.add_node(Node(NodeType.Value(float(rng.random())))))
        for m in range(4):
            mixes.append(g.add_node(Node(NodeType.Mix(MixType.ADD))))
        comb = g.add_node(Node(NodeType.CombineRgba()))
        comb_node = g.node_graph._node_with_id_mut(comb)
        comb_node.resize_policy = ResizePolicy.SpecificSize(Size(16, 16))
        combines.append(comb)
        blur = g.add_node(Node(NodeType.Blur(1.0)))
        warp = g.add_node(Node(NodeType.Warp(30.0, 4.0)))
        # structured source: BOTH Pattern outputs feed mixes so the
        # two-output source soaks under churn (NOTE: adding this node
        # REMAPPED every seed's sequence — pre-Pattern soak evidence is
        # historical)
        pattern = g.add_node(Node(NodeType.Pattern(
            16, 16, "Brick", cells_x=3, cells_y=5, mortar=0.15, bevel=0.06,
            seed=1,
        )))
        # cellular source: the borders field modulates a mix so the
        # three-output source soaks under churn (NOTE: adding this node
        # REMAPPED every seed's sequence — pre-Voronoi soak evidence is
        # historical)
        vor = g.add_node(Node(NodeType.Voronoi(
            16, 16, cells_x=3, cells_y=3, jitter=0.8, seed=2,
        )))
        # mortar spread: the jump-flood Distance field of the groove mask
        # — the one GLOBAL iterative op — soaks under churn (NOTE: adding
        # this node REMAPPED every seed's sequence — r4's
        # DISTANCE REMAP entry)
        dst = g.add_node(Node(NodeType.Distance(6.0)))
        # gradient source: a Ramp modulates a mix input so the fourth
        # procedural source soaks under churn (NOTE: adding this node
        # REMAPPED every seed's sequence again — r4's
        # RAMP REMAP entry)
        rmp = g.add_node(Node(NodeType.Ramp(16, 16, "Radial", 0.0, 0.5, 0.5, 1.2)))
        # final grade stage (NOTE: adding this node remapped every seed's
        # sequence again — see the HSV remap)
        hsv = g.add_node(Node(NodeType.Hsv(10.0, 1.1, 1.0)))
        # multi-scale occlusion of the groove mask (NOTE: adding this node
        # remapped every seed's sequence — see the AO remap)
        ao = g.add_node(Node(NodeType.AmbientOcclusion(2.0, 1.0)))
        out = g.add_node(Node(NodeType.OutputRgba("out")))
        # initial wiring (blur → warp between combine and output; the warp
        # strength comes from a gray Value so the gather stage soaks too)
        g.connect(values[0], mixes[0], SlotId(0), SlotId(0))
        g.connect(values[1], mixes[0], SlotId(0), SlotId(1))
        g.connect(pattern, ao, SlotId(0), SlotId(0))  # groove mask → AO
        g.connect(ao, mixes[1], SlotId(0), SlotId(0))
        g.connect(pattern, mixes[2], SlotId(1), SlotId(1))  # per-cell IDs
        g.connect(vor, mixes[1], SlotId(1), SlotId(1))  # voronoi borders
        g.connect(pattern, dst, SlotId(0), SlotId(0))  # groove mask → JFA
        g.connect(dst, mixes[3], SlotId(0), SlotId(0))
        g.connect(rmp, mixes[3], SlotId(0), SlotId(1))  # radial vignette
        g.connect(mixes[0], comb, SlotId(0), SlotId(0))
        g.connect(mixes[1], comb, SlotId(0), SlotId(1))
        g.connect(mixes[2], comb, SlotId(0), SlotId(2))
        g.connect(mixes[3], comb, SlotId(0), SlotId(3))
        g.connect(comb, blur, SlotId(0), SlotId(0))
        g.connect(blur, warp, SlotId(0), SlotId(0))
        g.connect(values[2], warp, SlotId(0), SlotId(1))
        g.connect(warp, hsv, SlotId(0), SlotId(0))
        g.connect(hsv, out, SlotId(0), SlotId(0))

    sources = values + mixes  # gray-or-rgba producers for mix inputs
    extras = []  # add/remove churn pool (action 7)

    for i in range(ITERS):
        n_edits = int(rng.integers(1, 4))
        with lg.write() as g:
            for _ in range(n_edits):
                # NOTE: widening 9 → 10 (Pattern), 10 → 11 (Hsv drags),
                # 11 → 12 (AO drags), 12 → 13 (Voronoi drags), 13 → 14
                # (Distance drags, r4), and 14 → 15 (Ramp drags, r4)
                # each remapped seeds too
                action = rng.integers(15)
                if action == 0:
                    node = values[rng.integers(len(values))]
                    g.node_mut(node).node_type = NodeType.Value(float(rng.random()))
                elif action == 1:
                    # NOTE: widening 5 → len(MixType) (extension blend
                    # modes) REMAPS every seed's edit sequence — evidence
                    # predating the widening is historical
                    mix = mixes[rng.integers(len(mixes))]
                    g.set_mix_type(mix, list(MixType)[rng.integers(len(MixType))])
                elif action == 2:
                    # rewire a mix input from an earlier source (acyclic:
                    # only allow sources added before the mix)
                    mix = mixes[rng.integers(len(mixes))]
                    pool = [s for s in sources if s < mix]
                    if pool:
                        src = pool[rng.integers(len(pool))]
                        g.connect(src, mix, SlotId(0), SlotId(int(rng.integers(2))))
                elif action == 3:
                    mix = mixes[rng.integers(len(mixes))]
                    try:
                        g.disconnect_slot(mix, Side.INPUT, SlotId(int(rng.integers(2))))
                    except Exception:
                        pass
                elif action == 4:
                    src = values[rng.integers(len(values))]
                    g.connect(src, comb, SlotId(0), SlotId(int(rng.integers(4))))
                elif action == 6:
                    # blur sigma edit (extension node on the output path)
                    g.set_blur_sigma(blur, float(rng.uniform(0.5, 2.5)))
                elif action == 8:
                    # warp drag (displacement gather on the output path)
                    g.set_warp(warp, float(rng.uniform(0, 360)),
                               float(rng.uniform(0.0, 8.0)))
                elif action == 10:
                    # hsv grade drag on the output path (argument-only)
                    g.set_hsv(
                        hsv,
                        float(rng.uniform(-360.0, 720.0)),
                        float(rng.uniform(0.0, 2.0)),
                        float(rng.uniform(0.5, 1.5)),
                    )
                elif action == 11:
                    # AO drag: strength is an argument; the occasional
                    # radius draw re-bakes the taps (refingerprints)
                    g.set_ambient_occlusion(
                        ao,
                        float(rng.uniform(0.5, 6.0)),
                        float(rng.choice([1.0, 1.0, 1.0, 0.7, 1.6])),
                    )
                elif action == 9:
                    # pattern drag: cells/mortar/bevel/seed are program
                    # arguments; the KIND draw sometimes reshapes the trace
                    g.set_pattern(
                        pattern, 16, 16,
                        ("Checker", "Brick", "Stripe")[rng.integers(3)],
                        int(rng.integers(1, 6)), int(rng.integers(1, 6)),
                        float(rng.uniform(0.0, 0.4)),
                        float(rng.choice([0.0, 0.08])),
                        int(rng.integers(0, 100)),
                    )
                elif action == 12:
                    # voronoi drag: cells/jitter/seed are all program
                    # arguments — every drag re-runs the cached executable
                    g.set_voronoi(
                        vor, 16, 16,
                        int(rng.integers(1, 6)), int(rng.integers(1, 6)),
                        float(rng.uniform(0.0, 1.0)),
                        int(rng.integers(0, 100)),
                    )
                elif action == 13:
                    # distance spread drag: max_dist is a program argument
                    # — every drag re-runs the cached executable
                    g.set_distance(dst, float(rng.uniform(1.0, 12.0)))
                elif action == 14:
                    # ramp drag: angle/center/scale are arguments; the
                    # KIND draw sometimes reshapes the trace
                    g.set_ramp(
                        rmp, 16, 16,
                        ("Linear", "Radial", "Box")[rng.integers(3)],
                        float(rng.uniform(-360.0, 360.0)),
                        float(rng.uniform(0.0, 1.0)),
                        float(rng.uniform(0.0, 1.0)),
                        float(rng.uniform(0.3, 2.5)),
                    )
                elif action == 7:
                    # structural churn: add a fresh Value wired into a mix,
                    # or remove one added earlier (dirties its children)
                    if extras and rng.random() < 0.5:
                        victim = extras.pop(int(rng.integers(len(extras))))
                        g.remove_node(victim)
                    else:
                        v = g.add_node(Node(NodeType.Value(float(rng.random()))))
                        mix = mixes[rng.integers(len(mixes))]
                        g.connect(v, mix, SlotId(0), SlotId(int(rng.integers(2))))
                        extras.append(v)
                else:
                    # resize policy/filter edits on a mix node
                    from kanter_core_tpu import ResizeFilter

                    mix = mixes[rng.integers(len(mixes))]
                    node = g.node_mut(mix)
                    if rng.integers(2):
                        node.resize_policy = ResizePolicy.SpecificSize(
                            Size(int(rng.integers(2, 24)), int(rng.integers(2, 24)))
                        )
                    else:
                        node.resize_filter = list(ResizeFilter)[rng.integers(5)]
            snapshot = g.node_graph.clone()

        # exercise edit HISTORY against the running engine: sometimes undo
        # the whole batch (one write() == one undo unit) while its dirty
        # work may still be in flight, then either redo it or leave it
        # undone — the render + truth comparison below uses whatever
        # topology results. NOTE: adding this draw REMAPPED every seed's
        # sequence again (soak history).
        history = rng.random()
        if history < 0.25 and lg.undo_depth() > 1:  # never undo the build
            assert lg.undo()
            if history < 0.125:
                assert lg.redo()
            else:
                # a batch that added extras is gone: drop dangling ids
                live_ids = set(lg.node_ids())
                extras[:] = [e for e in extras if e in live_ids]
            with lg.read() as g:
                snapshot = g.node_graph.clone()

        with LiveGraph.await_clean_read(lg, out) as g:
            engine_px = g.buffer_rgba(out, SlotId(0))
            committed_dtypes = {
                p.dtype.name for p in g.slot_data(out, SlotId(0)).image.planes
            }

        prog = CompiledGraph(snapshot, targets=[(out, SlotId(0))], include_u8=True)
        truth = np.asarray(prog()[(out, SlotId(0))]).reshape(-1)
        if precision is None:
            if not np.array_equal(engine_px, truth):
                diff = int((engine_px != truth).sum())
                raise SystemExit(
                    f"MISMATCH at iter {i}: {diff} bytes differ (seed {SEED})"
                )
        else:
            # bf16 mode is documented non-bit-exact (leaf + partition-
            # boundary quantization, DESIGN.md §9); the soak pins dtype
            # consistency, liveness, and catastrophe-freedom vs f32 truth
            if committed_dtypes != {"bfloat16"}:
                # the automatic capacity fallback (banded / oversized-node
                # retry) commits f32 BY DESIGN (correctness-first —
                # test_engine_bf16_capacity_path_interops); only flag a
                # non-bf16 commit when no tiled program was ever minted
                if tp.metrics()["tiled_programs"] == 0:
                    raise SystemExit(
                        f"NON-bf16 COMMIT at iter {i}: {committed_dtypes} "
                        f"(seed {SEED})"
                    )
            delta = np.abs(engine_px.astype(np.int32) - truth.astype(np.int32))
            frac_wild = float((delta > 32).mean())
            if frac_wild > 0.05:
                raise SystemExit(
                    f"bf16 DIVERGENCE at iter {i}: {frac_wild:.1%} of bytes "
                    f">32 LSB off f32 truth (seed {SEED})"
                )
        if (i + 1) % 20 == 0:
            print(f"iter {i + 1}/{ITERS} ok; cache={tp.recipe_cache.stats()}", flush=True)

    print(f"SOAK PASS: {ITERS} iterations, seed {SEED}")


if __name__ == "__main__":
    main()
