"""Per-op GPU perf table: ms + GB/s for every hot kernel.

Prints ONE JSON line per (op, canvas), naming the device, so every
throughput claim in module docstrings is reproducible from this script.
Uses the same protocol as bench.py (see benchlib.py): amortized two-length
lax.scan timing, forced materialization via optimization_barrier + checksum
fetch, per-iteration input variation.

Columns:
- ms:        amortized device time per evaluation
- gbps:      implied HBM traffic / time, using the op's minimal traffic model
             (reads + writes of planes it must materialize; fused temps are
             free). Compare against bench.py's measured `roofline_gbps`.
- gpix_s:    OUTPUT pixels per second (raw, not node-evals)

Run on the GPU (it refuses to run elsewhere). `KANTER_BENCHOPS_SIZES=2048,4096`
overrides the canvas list; `KANTER_BENCHOPS_OPS=mix,h2n` filters ops.
"""

from __future__ import annotations

import json
import os

import numpy as np

from benchlib import ScanBench, device_random

SIZES = [int(s) for s in os.environ.get("KANTER_BENCHOPS_SIZES", "2048,4096").split(",")]
ONLY = {s for s in os.environ.get("KANTER_BENCHOPS_OPS", "").split(",") if s}


def stages(canvas: int):
    """Yields (name, body(val, consts) -> planes, consts, traffic_bytes,
    out_pixels, n1, n2, base)."""
    from kanter_core_tpu.ops.blur import blur_plane
    from kanter_core_tpu.ops.height_to_normal import _h2n_jnp
    from kanter_core_tpu.ops.resize import resample_plane
    from kanter_core_tpu.geometry import Size
    from kanter_core_tpu.node import ResizeFilter

    plane_bytes = canvas * canvas * 4
    p1 = device_random((canvas, canvas), seed=1)
    p2 = device_random((canvas, canvas), seed=2)
    rgba = tuple(device_random((canvas, canvas), seed=10 + i) for i in range(4))

    # --- mix: one add (2 reads + 1 write) ---
    yield (
        "mix_add",
        lambda c, ps: ((ps[0] + c) + ps[1],),
        (p1, p2),
        3 * plane_bytes,
        canvas * canvas,
        8, 64, 0.25,
    )

    # --- row-gather calibration: the resample rows below are gather-bound;
    #     this measures what a bare [H] row gather achieves, so their GB/s
    #     can be judged against the achievable ceiling, not the copy
    #     ceiling ---
    import numpy as _np

    gather_idx = _np.random.default_rng(0).integers(0, canvas, canvas).astype(_np.int32)
    gather_idx.sort()

    def gather_body(c, ps):
        import jax.numpy as _jnp

        return ((ps[0] + c)[_jnp.asarray(gather_idx), :],)

    yield (
        "gather_rows_calib",
        gather_body,
        (p1,),
        2 * plane_bytes,
        canvas * canvas,
        8, 64, 0.25,
    )

    # --- i32 ALU envelope calibration: the compute-bound rows
    #     (distance_jfa, voronoi_cellular) are judged against what a
    #     pure-ALU i32 kernel of KNOWN op count achieves on this card, so
    #     those rows can report "% of the measured ALU envelope" the way
    #     bandwidth rows report % of
    #     roofline. The round body is the JFA fold's candidate evaluation
    #     VERBATIM (ops/distance.d2_of + the select fold) iterated on a
    #     rolling data-dependent state, so the op MIX (shift/and/sub/abs/
    #     cmp/select/mul/add on i32) matches what it calibrates. Op count
    #     per round, counted from the statements: valid-cmp 1, shifts 2-3,
    #     and 1, sub/abs 4, wrap-selects 6, valid-selects 2, d² 4,
    #     fold cmp+select 2, state update 3 = 24 plane ops; ROUNDS=24 →
    #     576 ops/px, ~36:1 compute:HBM ratio at 16 B/px (compute-bound
    #     by construction). Traffic model: 3 reads + 1 write. ---
    import jax.numpy as _jv
    from jax import lax as _lax

    _ALU_ROUNDS = 24
    _ALU_OPS_PER_ROUND = 24
    rows_i = _jv.broadcast_to(
        _jv.arange(canvas, dtype=_jv.int32)[:, None], (canvas, canvas)
    )
    cols_i = _jv.broadcast_to(
        _jv.arange(canvas, dtype=_jv.int32)[None, :], (canvas, canvas)
    )
    x0 = (p1 * np.float32(2**20)).astype(_jv.int32)

    def alu_body(c, ps):
        x, rp, cp = ps
        sent = _jv.int32(0x7FFFFFFF)
        far = sent
        half_h = _jv.int32(canvas // 2)
        hh = _jv.int32(canvas)
        x = x ^ c.astype(_jv.int32)
        acc = x | _jv.int32(1)
        for i in range(_ALU_ROUNDS):
            valid = x != sent
            cy = _jv.right_shift(x, _jv.int32(16))
            cx = _jv.bitwise_and(x, _jv.int32(0xFFFF))
            dy = _jv.abs(rp - cy)
            dy = _jv.where(dy > half_h, hh - dy, dy)
            dx = _jv.abs(cp - cx)
            dx = _jv.where(dx > half_h, hh - dx, dx)
            dy = _jv.where(valid, dy, _jv.int32(0))
            dx = _jv.where(valid, dx, _jv.int32(0))
            d2 = _jv.where(valid, dy * dy + dx * dx, far)
            better = d2 < acc
            acc = _jv.where(better, d2, acc)
            x = _jv.where(better, x ^ d2, x + _jv.int32(i + 1))
        return (acc + x,)

    yield (
        "alu_i32_calib",
        alu_body,
        (x0, rows_i, cols_i),
        4 * plane_bytes,
        canvas * canvas,
        8, 32, 1.0,
        {"intops_per_px": _ALU_ROUNDS * _ALU_OPS_PER_ROUND},
    )

    # --- mix chain ×16 (fusion probe: still 2 reads + 1 write) ---
    def chain_body(c, ps):
        x = ps[0] + c
        for i in range(16):
            x = x + ps[1] if i % 2 == 0 else x * ps[1]
        return (x,)

    yield ("mix_chain16", chain_body, (p1, p2), 3 * plane_bytes, canvas * canvas, 8, 64, 0.25)

    # --- height-to-normal (1 read + 3 writes min) ---
    # Variation: roll the input by the iteration index. Normals are nearly
    # invariant to both shifts (+c) and scales (×c) of the heightmap — the
    # normalize folds them out — so value variation produces colliding
    # checksums; rolling moves every pixel's stencil neighborhood instead,
    # with zero change to the op's arithmetic.
    import jax.numpy as _jnp

    def h2n_body(c, ps):
        rolled = _jnp.roll(ps[0], c.astype(_jnp.int32), axis=1)
        return _h2n_jnp(rolled)[:3]

    yield (
        "h2n",
        h2n_body,
        (p1,),
        4 * plane_bytes,
        canvas * canvas,
        8, 32, 1.0,  # sub-ms op: n2>=32 or the two-length diff is RTT jitter
    )

    # --- blur σ=1 and σ=5 (2 separable passes: 2 reads + 2 writes min) ---
    for sigma in (1.0, 5.0):
        yield (
            f"blur_s{int(sigma)}",
            (lambda s: lambda c, ps: (blur_plane(ps[0] + c, s),))(sigma),
            (p1,),
            4 * plane_bytes,
            canvas * canvas,
            8, 32, 0.25,  # sub-ms op: n2>=32 (CLAUDE.md noise floor)
        )

    # --- blur through the shard_map'd kernel on a 1-card mesh: the sharded
    #     composition's overhead vs the plain kernel (the ring halo exchange
    #     is a self-permute here; four cards add 2·radius·W rows over NVLink) ---
    import jax as _jax
    from jax.sharding import Mesh as _Mesh

    mesh1 = _Mesh(np.asarray(_jax.devices()[:1]), ("rows",))
    for sigma in (1.0, 5.0):
        yield (
            f"blur_sharded_s{int(sigma)}",
            (lambda s, m: lambda c, ps: (blur_plane(ps[0] + c, s, mesh=m),))(
                sigma, mesh1
            ),
            (p1,),
            4 * plane_bytes,
            canvas * canvas,
            8, 32, 0.25,
        )

    # --- levels remap (compute-bound off-CPU: corrected div + ds_pow) ---
    from kanter_core_tpu.ops.levels import levels_plane

    lv_params = np.asarray([0.15, 0.85, 2.3, 0.05, 0.95], np.float32)

    yield (
        "levels",
        lambda c, ps: (levels_plane(ps[0] + c, lv_params),),
        (p1,),
        2 * plane_bytes,
        canvas * canvas,
        8, 32, 0.25,  # sub-ms op: n2>=32 (CLAUDE.md noise floor)
    )

    # --- identity-gamma Levels (r5 fast path): the lax.cond skips
    #     ds_pow's double-single exp/log — the slider-at-rest case drops
    #     from compute-bound to the traffic floor ---
    import jax.numpy as _jl

    lv1_params = _jl.asarray([0.15, 0.85, 1.0, 0.05, 0.95], _jl.float32)

    yield (
        "levels_gamma1",
        lambda c, ps: (levels_plane(ps[0] + c, lv1_params),),
        (p1,),
        2 * plane_bytes,
        canvas * canvas,
        8, 32, 0.25,
    )

    # --- FBM noise source (4 octaves, compute-bound: 16 lattice hashes +
    #     interp per pixel; traffic model = the single output write). The
    #     scan value drives PERSISTENCE (a runtime argument) so every
    #     iteration's checksum is distinct without integer-cast tricks. ---
    from kanter_core_tpu.ops.noise import noise_bindings, noise_plane

    nb = noise_bindings((canvas, canvas, 8, 4, 12345, 0.5))

    def noise_body(c, ps):
        rows, cols, fx, fy, periods = ps
        return (noise_plane(rows, cols, np.uint32(12345), c, fx, fy, periods),)

    yield (
        "noise_fbm4",
        noise_body,
        (nb["rows"], nb["cols"], nb["fx"], nb["fy"], nb["periods"]),
        plane_bytes,
        canvas * canvas,
        8, 32, 0.25,
    )

    # --- Brick pattern source (integer-hash lattice + groove ramp; traffic
    #     model = the two output writes, mask + cells). The scan value
    #     drives the SEED (a runtime u32 argument): it re-hashes every
    #     cell's ID, which the checksum's corner slice always sees.
    #     Driving MORTAR collided checksums at 4096 — the corner pixel
    #     sits at a groove CENTER (flat 0 for any width) and the center
    #     pixel mid-brick (flat 1), so width drags were invisible to the
    #     corner+center checksum even at groove-moving step sizes. ---
    from kanter_core_tpu.ops.pattern import pattern_bindings, pattern_planes

    pb = pattern_bindings((canvas, canvas, "Brick", 7, 13, 0.15, 0.05, 4242))

    def pattern_body(c, ps):
        import jax.numpy as _j

        rows, cols, fx, fy, px, py, _seed = ps
        return pattern_planes(
            "Brick", rows, cols, fx, fy, px, py,
            np.float32(0.15), np.float32(0.05), c.astype(_j.uint32),
        )

    yield (
        "pattern_brick",
        pattern_body,
        (pb["rows"], pb["cols"], pb["fx"], pb["fy"], pb["px"], pb["py"],
         pb["seed"]),
        2 * plane_bytes,
        canvas * canvas,
        8, 32, 0.25,
    )

    # --- directional warp (strength read + 4-neighbor gathered input read
    #     + out write; traffic model counts the input once, so the GB/s is
    #     a LOWER bound — judge against gather_rows_calib, not the copy
    #     roofline). The scan value shifts the strength field, so every
    #     iteration gathers a different displacement pattern. ---
    from kanter_core_tpu.ops.warp import warp_bindings, warp_planes

    wb = warp_bindings((57.0, 24.0))
    warp_rows = np.arange(canvas, dtype=np.int32)

    def warp_body(c, ps):
        return warp_planes(
            (ps[0],), (ps[1] + c) % 1.0, warp_rows, warp_rows,
            ps[2], canvas, canvas,
        )

    yield (
        "warp_directional",
        warp_body,
        (p1, p2, wb["k"]),
        3 * plane_bytes,
        canvas * canvas,
        8, 32, 0.25,
    )

    import jax.numpy as _jnp

    # --- resample up ×2 and down ×2, Triangle + Lanczos3
    #     (traffic: in read + tmp[outH,inW] write+read + out write) ---
    for filt, fname in ((ResizeFilter.TRIANGLE, "tri"), (ResizeFilter.LANCZOS3, "lcz")):
        for scale, sname in ((2.0, "up2x"), (0.5, "dn2x")):
            out_hw = int(canvas * scale)
            tmp_bytes = out_hw * canvas * 4
            out_bytes = out_hw * out_hw * 4
            yield (
                f"resample_{fname}_{sname}",
                (lambda f, o: lambda c, ps: (
                    resample_plane((ps[0] + c) % 1.0, Size(o, o), f),
                ))(filt, out_hw),
                (p1,),
                plane_bytes + 2 * tmp_bytes + out_bytes,
                out_hw * out_hw,
                8, 32, 0.25,  # fast op: needs a long scan to clear the noise floor
            )

    # --- Hsv color adjust, RGBA (3 color reads + 3 writes; alpha is an
    #     alias, not traffic). The scan value drives the VALUE scale (a
    #     runtime argument riding in the params vector) so every
    #     iteration's checksum is distinct. The divides go through
    #     corrected_div on the GPU (the cross-backend determinism tax) and
    #     the hexcone select tree adds compute on top of the traffic. ---
    from kanter_core_tpu.ops.hsv import hsv_planes

    def hsv_body(c, ps):
        params = _jnp.stack([_jnp.float32(1.7), _jnp.float32(0.8), c % 2.0])
        return tuple(hsv_planes(list(ps), params)[:3])

    yield (
        "hsv_rgba",
        hsv_body,
        rgba,
        6 * plane_bytes,
        canvas * canvas,
        8, 32, 0.25,
    )

    # --- Curvature (wrap Laplacian: 1 read + 1 write; the 4 rolls fuse —
    #     the h2n few-operand stencil class, CLAUDE.md). Variation: roll
    #     the input by the iteration index (the h2n driver). Driving
    #     STRENGTH alone lets XLA hoist the c-invariant Laplacian out of
    #     the scan (measured: the row collapsed below the noise floor);
    #     value variation (+c) is no better — the Laplacian is
    #     shift-invariant. The roll moves every stencil neighborhood with
    #     zero change to the op's arithmetic. ---
    from kanter_core_tpu.ops.curvature import curvature_plane

    def curvature_body(c, ps):
        rolled = _jnp.roll(ps[0], c.astype(_jnp.int32), axis=1)
        return (curvature_plane(rolled, _jnp.float32(5.0)),)

    yield (
        "curvature",
        curvature_body,
        (p1,),
        2 * plane_bytes,
        canvas * canvas,
        8, 32, 1.0,  # integer roll offsets (step=1 via the h2n rule)
    )

    # --- AmbientOcclusion radius=2, the flagship payload (3 wrap blurs at
    #     sigmas 2/4/8 + the rewrite-guarded combine). The ENGINE bands AO
    #     at capacity (AO is bandable): pinned by
    #     test_tiled.py::test_ao_at_capacity_bands_through_engine.
    #     Minimal-traffic model: each separable blur is 2 passes
    #     (in+tmp+tmp+out = 4 planes) ×3, plus the combine's 3 blurred
    #     reads + center read + out write; the GB/s is a LOWER bound when
    #     XLA fuses the combine into the last pass. Variation: roll the
    #     input by the iteration index (the h2n driver) — a first attempt
    #     drove STRENGTH, and XLA hoisted the three c-invariant blurs out
    #     of the scan entirely (measured 0.31 ms ≈ the combine alone,
    #     implied 3.7 TB/s — fiction); the roll forces the whole op to run
    #     per iteration. ---
    from kanter_core_tpu.ops.ambient_occlusion import ao_plane

    def ao_body(c, ps):
        rolled = _jnp.roll(ps[0], c.astype(_jnp.int32), axis=1)
        return (ao_plane(rolled, _jnp.float32(2.0), 2.0),)

    yield (
        "ambient_occlusion_r2",
        ao_body,
        (p1,),
        17 * plane_bytes,
        canvas * canvas,
        8, 32, 1.0,  # integer roll offsets
    )

    # --- Distance (jump flooding): ceil(log2(canvas))+1 step-batched
    #     passes over the packed nearest-seed state, one XLA loop fusion
    #     per step. Traffic model per far step: 3 window reads + 1 state
    #     write (near steps 2), + mask read + fade write. ~190 int-ops/px/
    #     step, so the row also reports its share of the ALU envelope.
    #     The scan value drives MAX_DIST (a traced argument). ---
    from kanter_core_tpu.ops.distance import _jfa_steps, distance_plane

    dist_mask = (device_random((canvas, canvas), seed=5) > 0.998).astype(
        np.float32
    )
    steps = _jfa_steps(canvas, canvas)
    dist_traffic = (
        sum((4 if k >= 8 else 2) for k in steps) + 2
    ) * plane_bytes

    # Modeled int-op count (for pct_of_alu_envelope, counted from
    # ops/distance.d2_of + the 8-candidate fold): d2_of = 19 plane ops;
    # per step = 19 (step-start) + 8 × (19 + cmp + 2 selects) = 195.
    yield (
        "distance_jfa",
        lambda c, ps: (distance_plane(ps[0], c * np.float32(100.0)),),
        (dist_mask,),
        dist_traffic,
        canvas * canvas,
        2, 8, 0.25,  # multi-ms op: short scan clears the noise floor
        {"modeled_intops_per_px": 195 * len(steps)},
    )

    # --- Voronoi cellular source (25-candidate exact window; compute-
    #     bound: 75 lattice hashes per pixel; traffic model = the three
    #     output writes). The scan value drives JITTER (a traced
    #     argument). ---
    from kanter_core_tpu.ops.voronoi import voronoi_bindings, voronoi_planes

    vb = voronoi_bindings((canvas, canvas, 24, 24, 1.0, 99))

    def voronoi_body(c, ps):
        rows, cols = ps
        return voronoi_planes(
            rows, cols, vb["fx"], vb["fy"], vb["px"], vb["py"],
            c % 1.0, vb["seed"],
        )

    # Modeled int-op count (for pct_of_alu_envelope, counted from
    # ops/voronoi.candidate): 3 lowbias32 hashes × 13 plane ops (the two
    # leading muls are VECTOR ops — free at plane scale) + jitter offsets
    # 4 + deltas 2 + d² 3 + fold cmp/min/selects 5 = 53/candidate × 25.
    yield (
        "voronoi_cellular",
        voronoi_body,
        (vb["rows"], vb["cols"]),
        3 * plane_bytes,
        canvas * canvas,
        8, 32, 0.25,
        {"modeled_intops_per_px": 53 * 25},
    )

    # --- Ramp gradient source (elementwise coordinate math; traffic
    #     model = the single output write). The scan value drives the
    #     ANGLE's projection via the k vector (runtime argument). ---
    from kanter_core_tpu.ops.ramp import ramp_bindings, ramp_plane

    rb = ramp_bindings((canvas, canvas, "Radial", 0.0, 0.5, 0.5, 1.0))

    def ramp_body(c, ps):
        import jax.numpy as _j

        rows, cols, iw, ih = ps
        k = _j.stack([_j.float32(1.0), _j.float32(0.0), c % 1.0,
                      _j.float32(0.5), _j.float32(1.2)])
        return (ramp_plane("Radial", rows, cols, iw, ih, k),)

    yield (
        "ramp_radial",
        ramp_body,
        (rb["rows"], rb["cols"], rb["iw"], rb["ih"]),
        plane_bytes,
        canvas * canvas,
        8, 64, 0.25,
    )

    # --- u8 export, RGBA interleave (4 f32 reads + 1 u32 write): the
    #     PRODUCTION pack formulation (slot_image's little-endian u32) ---
    from kanter_core_tpu.ops.common import f32_to_u8

    def u8_body(c, ps):
        import jax.numpy as _jnp

        r8 = f32_to_u8((ps[0] + c) % 1.0)
        g8, b8, a8 = (f32_to_u8(p) for p in ps[1:])
        packed = (
            r8.astype(_jnp.uint32)
            | (g8.astype(_jnp.uint32) << 8)
            | (b8.astype(_jnp.uint32) << 16)
            | (a8.astype(_jnp.uint32) << 24)
        )
        # the full u32 pack is the measured output; benchlib's checksum
        # wrap-sums integer planes exactly, so r8-sized deltas stay visible
        return (packed,)

    yield (
        "u8_export_rgba",
        u8_body,
        rgba,
        4 * plane_bytes + canvas * canvas * 4,
        canvas * canvas,
        8, 64, 0.02,
    )


def main() -> None:
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(f"bench_ops.py measures the GPU; JAX's device is {device}")
    for canvas in SIZES:
        alu_envelope = None  # measured int-ops/s from this run's calib row
        for stage in stages(canvas):
            name, body, consts, traffic, out_px, n1, n2, base = stage[:8]
            meta = stage[8] if len(stage) > 8 else {}
            if ONLY and not any(name.startswith(o) for o in ONLY):
                continue
            # u8 quantization: vary inputs in steps ≥ 1/128 so consecutive
            # iterations round to different u8 values; h2n: integer roll
            # offsets (see h2n_body)
            if name.startswith("u8"):
                step = 1.0 / 128.0
            elif name.startswith(("h2n", "curvature", "ambient", "alu")):
                step = 1.0  # integer roll/xor offsets drive the variation
            elif name.startswith("pattern"):
                step = 1.0  # integer seed steps (see the row comment)
            else:
                step = 1e-4
            bench = ScanBench(body, consts, n1=n1, n2=n2, base=base, step=step)
            seconds, distinct = bench.run(repeats=3)
            row = {
                "op": name,
                "canvas": canvas,
                "device": device.device_kind,
                "ms": round(seconds * 1e3, 4),
                "gbps": round(traffic / seconds / 1e9, 1),
                "gpix_s": round(out_px / seconds / 1e9, 3),
                "checksums_distinct": distinct,
            }
            if name == "alu_i32_calib":
                # per-run envelope: measured int-ops/s of the known-count
                # pure-ALU kernel (see the stage comment)
                alu_envelope = meta["intops_per_px"] * canvas * canvas / seconds
                row["intops_per_px"] = meta["intops_per_px"]
                row["alu_envelope_tops"] = round(alu_envelope / 1e12, 3)
            elif "modeled_intops_per_px" in meta and alu_envelope:
                # compute-bound rows: % of this run's ALU envelope the op
                # achieves under its modeled op count — a 2× kernel
                # regression now FAILS a falsifiable ratio instead of
                # hiding behind an unmeasured "compute-bound" claim
                modeled_s = meta["modeled_intops_per_px"] * canvas * canvas / alu_envelope
                row["modeled_intops_per_px"] = meta["modeled_intops_per_px"]
                row["pct_of_alu_envelope"] = round(100.0 * modeled_s / seconds, 1)
            if seconds <= 5e-6:
                # the two-length difference vanished into timing noise: the
                # op is faster than this protocol can resolve — say so
                # instead of printing fictional bandwidth
                row.update({"ms": None, "gbps": None, "gpix_s": None, "below_noise_floor": True})
            print(json.dumps(row))


if __name__ == "__main__":
    main()
