"""Device parity battery: f32 planes on the default backend vs XLA:CPU.

The engine's contract is that every op gives the same f32 bits on every
backend (CLAUDE.md, "Correctness rules"): the recipe cache and the
fused/per-node/tiled/bucketed parity rest on it. Each row below runs a
production kernel on seeded inputs. `run_battery()` runs every row on this
process's default backend and, in a child process with `JAX_PLATFORMS=cpu`
(which never opens an accelerator), on XLA:CPU, and compares the planes bit
for bit, NaN payloads excluded (as `tests/conftest.py` does).

A row's `allowed` count is the stated bound for a known, measured
difference: glibc's powf misrounds a few inputs that `ds_pow` (the GPU's
pow, `ops/exact_math.py`) rounds correctly, and u8 export absorbs every one.

`probe_numerics()` measures the backend properties that
`exact_math.NUMERICS` records, so a run on a new card checks its row.

Run the battery alone with `python -m kanter_core_tpu.parity`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

#: flagship composition canvas of the `flagship` row (the CPU side finishes
#: in minutes at this size)
FLAGSHIP_CANVAS = 2048


def _u8(x):
    """numpy twin of `ops.common.f32_to_u8` (clamp, ×255, NaN→255, trunc)."""
    x = np.asarray(x, np.float32)
    v = np.clip(x, np.float32(0), np.float32(1)) * np.float32(255)
    v = np.where(np.isnan(v), np.float32(255), np.minimum(v, np.float32(255)))
    return v.astype(np.uint8)


def cases(flagship_canvas: int = FLAGSHIP_CANVAS):
    """[(name, thunk, allowed_f32_diffs)] — each thunk returns a pytree of
    planes computed on the process's default backend, so each side runs its
    own production gates (`exact_math.numerics()`)."""
    import jax
    import jax.numpy as jnp

    from . import MixType, Node, NodeGraph, NodeType, ResizePolicy, Size, SlotId
    from .node import ResizeFilter
    from .ops.height_to_normal import _h2n_jnp
    from .ops.mix import _binary, _gray_kernel
    from .ops.resize import resample_plane

    grid = np.arange(256, dtype=np.float32) / np.float32(255.0)
    A = np.tile(grid[:, None], (1, 256))
    B = np.tile(grid[None, :], (256, 1))
    rng = np.random.default_rng(0)
    h = rng.integers(0, 256, (512, 512)).astype(np.float32) / np.float32(255.0)
    src = rng.integers(0, 256, (173, 211)).astype(np.float32) / np.float32(255.0)
    wide_a = (rng.standard_normal(1 << 18) * np.exp(rng.uniform(-30, 30, 1 << 18))).astype(np.float32)
    wide_b = (rng.standard_normal(1 << 18) * np.exp(rng.uniform(-30, 30, 1 << 18))).astype(np.float32)
    # every f32 in [1, 4): all mantissas of both exponent parities — the
    # near-midpoint roots a one-step Newton sqrt can tie the wrong way
    sweep = np.arange(
        np.float32(1).view(np.uint32), np.float32(4).view(np.uint32), 97, dtype=np.uint32
    ).view(np.float32)

    out = []
    for mt in MixType:
        # POW: the GPU runs ds_pow (correctly rounded); the CPU runs glibc
        # powf, which misrounds 48 of the 65536 grid points
        out.append((f"mix_{mt.name}", lambda mt=mt: _gray_kernel(mt)(A, B),
                    48 if mt == MixType.POW else 0))

    from .ops.exact_math import exact_div, exact_pow, exact_sqrt

    out.append(("exact_div_wide", lambda: jax.jit(exact_div)(wide_a, wide_b), 0))
    out.append(("exact_sqrt_sweep", lambda: jax.jit(exact_sqrt)(sweep), 0))
    out.append(("exact_sqrt_wide", lambda: jax.jit(exact_sqrt)(np.abs(wide_a)), 0))
    out.append(("exact_pow_gamma", lambda: jax.jit(exact_pow)(
        src, np.float32(2.2) + np.zeros_like(src)), 48))
    out.append(("height_to_normal", lambda: jax.jit(_h2n_jnp)(h), 0))

    from .ops.blur import blur_plane

    out.append(("blur_sigma2.2", lambda: jax.jit(lambda x: blur_plane(x, 2.2))(src), 0))
    out.append(("blur_sigma20", lambda: jax.jit(lambda x: blur_plane(x, 20.0))(h), 0))

    def _sharded_blur():
        from jax.sharding import Mesh

        mesh = Mesh(np.asarray(jax.devices()[:1]), ("rows",))
        return jax.jit(lambda x: blur_plane(x, 2.2, mesh=mesh))(src)

    # the shard_map'd kernel (ring ppermute halo exchange) on a 1-device mesh
    out.append(("blur_sharded", _sharded_blur, 0))

    def _bucketed_row():
        # the shape-bucketed evaluator's data-movement formulations (indexed
        # two-pass resample over padded planes, gathered H2N neighbors with
        # host-computed texel steps, column-gather blur horizontal pass)
        from .bucketed import BucketedGraph

        g = NodeGraph()
        gin = g.add_node(Node(NodeType.InputGray("in")))
        val = g.add_node(Node(NodeType.Value(0.7)))
        mix = Node(NodeType.Mix(MixType.MULTIPLY))
        mix.resize_policy = ResizePolicy.SpecificSize(Size(97, 411))
        mix = g.add_node(mix)
        g.connect(gin, mix, SlotId(0), SlotId(0))
        g.connect(val, mix, SlotId(0), SlotId(1))
        h2n = g.add_node(Node(NodeType.HeightToNormal()))
        g.connect(mix, h2n, SlotId(0), SlotId(0))
        bl = g.add_node(Node(NodeType.Blur(1.3)))
        g.connect(h2n, bl, SlotId(0), SlotId(0))
        out_node = g.add_node(Node(NodeType.OutputRgba("out")))
        g.connect(bl, out_node, SlotId(0), SlotId(0))
        bg = BucketedGraph(
            g, targets=[(out_node, SlotId(0))],
            bindings={f"input_{int(gin)}": (src,)},
        )
        return tuple(bg()[(out_node, SlotId(0))])

    out.append(("bucketed_mix_h2n_blur", _bucketed_row, 0))

    from .ops.levels import levels_plane

    # Levels routes pow through exact_pow: like mix_POW, the only allowed
    # diffs are inputs where glibc powf itself misrounds
    out.append(("levels_remap", lambda: jax.jit(levels_plane)(
        src, np.asarray([0.15, 0.85, 2.3, 0.05, 0.95], np.float32)), 80))
    # identity gamma takes the lax.cond fast path (no pow at all)
    out.append(("levels_identity_gamma", lambda: jax.jit(levels_plane)(
        src, np.asarray([0.15, 0.85, 1.0, 0.05, 0.95], np.float32)), 0))

    def _noise_row():
        from .ops.noise import noise_bindings, noise_plane

        b = noise_bindings((211, 173, 5, 4, 12345, 0.55))
        return jax.jit(noise_plane)(
            b["rows"], b["cols"], b["seed"], b["persistence"],
            b["fx"], b["fy"], b["periods"],
        )

    out.append(("noise_fbm", _noise_row, 0))

    def _pattern_row():
        from .ops.pattern import pattern_bindings, pattern_planes

        outs = []
        for kind in ("Checker", "Brick", "Stripe"):
            b = pattern_bindings((211, 173, kind, 5, 7, 0.18, 0.07, 4242))
            mask, cells = jax.jit(pattern_planes, static_argnums=0)(
                kind, b["rows"], b["cols"], b["fx"], b["fy"],
                b["px"], b["py"], b["mortar"], b["bevel"], b["seed"],
            )
            outs.append(jnp.concatenate([mask, cells], axis=0))
        return jnp.concatenate(outs, axis=0)

    out.append(("pattern_kinds", _pattern_row, 0))

    def _voronoi_row():
        from .ops.voronoi import voronoi_bindings, voronoi_planes

        outs = []
        for cells_x, cells_y, jitter, seed in ((5, 7, 0.85, 4242), (4, 4, 0.0, 17)):
            b = voronoi_bindings((211, 173, cells_x, cells_y, jitter, seed))
            planes = jax.jit(voronoi_planes)(
                b["rows"], b["cols"], b["fx"], b["fy"],
                b["px"], b["py"], b["jitter"], b["seed"],
            )
            outs.append(jnp.concatenate(list(planes), axis=0))
        return jnp.concatenate(outs, axis=0)

    out.append(("voronoi_cellular", _voronoi_row, 0))

    def _ramp_row():
        from .ops.ramp import ramp_bindings, ramp_plane

        outs = []
        for kind, angle, cx, cy, scale in (
            ("Linear", 37.5, 0.3, 0.7, 1.4),
            ("Linear", 90.0, 0.5, 0.5, 1.0),
            ("Radial", 0.0, 0.45, 0.55, 1.2),
            ("Box", 0.0, 0.5, 0.5, 2.0),
        ):
            b = ramp_bindings((211, 173, kind, angle, cx, cy, scale))
            outs.append(jax.jit(ramp_plane, static_argnums=0)(
                kind, b["rows"], b["cols"], b["iw"], b["ih"], b["k"],
            ))
        return jnp.concatenate(outs, axis=0)

    out.append(("ramp_gradient", _ramp_row, 0))

    def _hsv_row():
        from .ops.hsv import hsv_bindings, hsv_planes

        g_, b_ = np.roll(src, 37, axis=0), np.roll(src, 91, axis=1)
        outs = []
        for params in ((123.4, 0.6, 1.2), (-450.0, 2.0, 0.8)):
            outs.extend(jax.jit(
                lambda pr, a, c, d: hsv_planes([a, c, d], pr)
            )(hsv_bindings(params), src, g_, b_))
        return jnp.concatenate(outs, axis=0)

    out.append(("hsv_adjust", _hsv_row, 0))

    from .ops.ambient_occlusion import ao_plane
    from .ops.curvature import curvature_plane
    from .ops.distance import distance_plane

    out.append(("curvature", lambda: jax.jit(curvature_plane)(src, np.float32(7.3)), 0))
    out.append(("ambient_occlusion", lambda: jax.jit(
        lambda s, p: ao_plane(p, s, 1.4))(np.float32(3.1), src), 0))
    out.append(("distance_jfa", lambda: jax.jit(distance_plane)(
        (src > 0.82).astype(np.float32), np.float32(9.0)), 0))

    def _gradient_row():
        from .ops.gradient import gradient_bindings, gradient_planes

        b = gradient_bindings((
            (0.0, 0.05, 0.1, 0.3, 1.0),
            (0.35, 0.8, 0.5, 0.2, 1.0),
            (0.7, 0.95, 0.9, 0.6, 0.9),
            (1.0, 1.0, 1.0, 1.0, 1.0),
        ))
        return jax.jit(gradient_planes)(src, b["pos"], b["colors"])

    out.append(("gradient_map", _gradient_row, 0))

    hh, ww = src.shape
    rows, cols = np.arange(hh, dtype=np.int32), np.arange(ww, dtype=np.int32)

    def _transform_row():
        from .ops.transform import transform_bindings, transform_planes

        b = transform_bindings((7.25, -3.5, 33.0, 1.3, 0.8))
        return jax.jit(transform_planes, static_argnums=(6, 7))(
            (src,), rows, cols, b["cs"], b["inv_s"], b["off"], hh, ww,
        )[0]

    out.append(("transform_affine", _transform_row, 0))

    from .ops.warp import warp_bindings, warp_halo, warp_planes, warp_planes_mesh

    strength = src * np.float32(0.9)
    wb = warp_bindings((57.0, 18.5))
    out.append(("warp_directional", lambda: jax.jit(warp_planes, static_argnums=(5, 6))(
        (src,), strength, rows, cols, wb["k"], hh, ww)[0], 0))

    def _warp_mesh_row():
        from jax.sharding import Mesh

        mesh = Mesh(np.asarray(jax.devices()[:1]), ("rows",))
        halo = warp_halo(18.5)
        return jax.jit(lambda ps, st, k: warp_planes_mesh(
            ps, st, k, mesh, "rows", halo, hh, ww))((src,), strength, wb["k"])[0]

    out.append(("warp_mesh_sharded", _warp_mesh_row, 0))

    def _warp_banded_row():
        b = warp_bindings((301.0, 27.5))  # negative-k quadrant, bucket 16
        halo = warp_halo(27.5)
        st = src * np.float32(1.6) - np.float32(0.3)  # clamp's active range
        band = np.arange(40, 48, dtype=np.int32)  # one interior 8-row band
        need = np.unique((band[:, None] + np.arange(-halo, halo + 1)[None, :]).ravel() % hh)
        lut = np.zeros(hh, np.int32)
        lut[need] = np.arange(len(need), dtype=np.int32)
        sub = np.ascontiguousarray(src[need])

        def f(subp, st_, lut_):
            return warp_planes((subp,), st_, band, cols, b["k"], hh, ww,
                               row_local=lambda y: lut_[y])[0]

        return jax.jit(f)(sub, st[band], lut)

    out.append(("warp_banded_lut", _warp_banded_row, 0))

    def _blend_row():
        def chain(a, b):
            d = _binary(MixType.DARKEN)(a, b)
            li = _binary(MixType.LIGHTEN)(a, b)
            s = _binary(MixType.SCREEN)(d, li)
            return _binary(MixType.OVERLAY)(s, _binary(MixType.DIFFERENCE)(a, b))

        return jax.jit(chain)(src, jnp.roll(src, 1, axis=0))

    out.append(("blend_modes", _blend_row, 0))

    def _wood_row():
        from .compiler import CompiledGraph
        from .models import wood_material_graph

        g = wood_material_graph(size=96)
        targets = [(oid, SlotId(0)) for oid in sorted(g.output_ids(), key=int)]
        res = CompiledGraph(g, targets=targets)()
        return tuple(np.asarray(p) for t in targets for p in res[t])

    # the procedural-material composition through the fused compiler; its
    # Levels gamma routes pow, whose glibc misrounds can propagate through
    # the downstream gather/stencil consumers
    out.append(("wood_material_fused", _wood_row, 100))

    from .slot_image import _jitted_converters

    ramp = (np.arange(65536, dtype=np.float32) / 65535.0).reshape(256, 256)
    out.append(("srgb_u8_export", lambda: _jitted_converters()["gray_to_u8_srgb"](ramp), 0))
    mean_rng = np.random.default_rng(77)
    mr, mg, mb = (
        mean_rng.integers(0, 256, (128, 128)).astype(np.float32) / np.float32(255.0)
        for _ in range(3)
    )
    out.append(("rgba_to_gray_mean", lambda: _jitted_converters()["rgb_mean"](mr, mg, mb), 0))
    for filt in ResizeFilter:
        out.append((f"resample_{filt.name}", lambda f=filt: jax.jit(
            lambda x: resample_plane(x, Size(300, 97), f))(src), 0))

    def _flagship_row():
        from .compiler import CompiledGraph
        from .graphs import flagship_graph

        graph, inputs, target = flagship_graph(flagship_canvas)
        prog = CompiledGraph(graph, targets=[(target, SlotId(0))])
        frng = np.random.default_rng(1)
        for node in inputs:
            prog.bind_input(node, [frng.random((flagship_canvas,) * 2, dtype=np.float32)])
        return tuple(np.asarray(p) for p in prog()[(target, SlotId(0))])

    # every op family in one fused program, at a real canvas
    out.append(("flagship", _flagship_row, 0))
    return out


def _stack(tree):
    import jax

    return np.stack([np.asarray(p) for p in jax.tree.leaves(tree)])


def dump(path: str, flagship_canvas: int = FLAGSHIP_CANVAS) -> None:
    """Run every row on this process's default backend; save the planes."""
    np.savez(path, **{name: _stack(fn()) for name, fn, _ in cases(flagship_canvas)})


def compare_row(got, ref) -> dict:
    """f32 bit differences (NaN payloads excluded), max ulp distance over
    finite pairs, and differing u8 export bytes of one row."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        return {"diffs": -1, "max_ulp": -1, "u8_diffs": -1}
    if got.dtype.kind != "f":
        n = int((got != ref).sum())
        return {"diffs": n, "max_ulp": 0, "u8_diffs": n}
    g, r = got.astype(np.float32), ref.astype(np.float32)
    bad = (g.view(np.uint32) != r.view(np.uint32)) & ~(np.isnan(g) & np.isnan(r))
    ok = bad & np.isfinite(g) & np.isfinite(r)
    gi, ri = g.view(np.int32).astype(np.int64), r.view(np.int32).astype(np.int64)
    gi = np.where(gi < 0, -(gi & 0x7FFFFFFF), gi)  # ordered integer line
    ri = np.where(ri < 0, -(ri & 0x7FFFFFFF), ri)
    max_ulp = int(np.abs(gi - ri)[ok].max()) if ok.any() else 0
    return {"diffs": int(bad.sum()), "max_ulp": max_ulp,
            "u8_diffs": int((_u8(g) != _u8(r)).sum())}


def start_reference(path: str, flagship_canvas: int = FLAGSHIP_CANVAS):
    """Start the XLA:CPU side in a child process with `JAX_PLATFORMS=cpu`
    (it never opens an accelerator, so it can run beside this process's
    work on the card); it writes every row's planes to `path`."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen(
        [sys.executable, "-m", "kanter_core_tpu.parity", "--dump", path,
         str(flagship_canvas)],
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )


def finish_battery(proc, path: str, flagship_canvas: int = FLAGSHIP_CANVAS,
                   timeout: float = 1500) -> list:
    """Run every row on this process's backend and compare with the child
    started by `start_reference`. Returns [(name, stats, allowed)]; a row
    passes when `diffs <= allowed` and its u8 export is identical."""
    mine = [(name, _stack(fn()), allowed) for name, fn, allowed in cases(flagship_canvas)]
    if proc.wait(timeout=timeout) != 0:
        raise RuntimeError(f"the XLA:CPU reference process exited {proc.returncode}")
    ref = np.load(path)
    return [(name, compare_row(got, ref[name]), allowed) for name, got, allowed in mine]


def run_battery(flagship_canvas: int = FLAGSHIP_CANVAS) -> list:
    """`start_reference` + `finish_battery` in one call."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cpu_ref.npz")
        proc = start_reference(path, flagship_canvas)
        try:
            return finish_battery(proc, path, flagship_canvas)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def row_ok(stats: dict, allowed: int) -> bool:
    return 0 <= stats["diffs"] <= allowed and stats["u8_diffs"] == 0


def probe_numerics():
    """Measure `exact_math.Numerics` on the default backend: FMA contraction
    of `a*b + c`, correct rounding of `/` and `sqrt` (vs numpy's IEEE ops),
    and `pow` vs glibc's powf (as XLA:CPU calls it, on the host device)."""
    import jax
    import jax.numpy as jnp

    from .ops.exact_math import Numerics

    rng = np.random.default_rng(0)
    n = 1 << 20
    a, b = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    c = rng.random(n, dtype=np.float32) - np.float32(0.5)
    grid = np.arange(256, dtype=np.float32) / np.float32(255.0)
    ga, gb = np.repeat(grid, 256), np.tile(grid, 256)

    def same(x, y):
        return bool(np.array_equal(np.asarray(x).view(np.uint32), np.asarray(y).view(np.uint32)))

    fma = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    return Numerics(
        fma_contracts=not same(fma, a * b + c),
        div_correctly_rounded=same(jax.jit(jnp.divide)(a, b + np.float32(0.01)),
                                   a / (b + np.float32(0.01))),
        sqrt_correctly_rounded=same(jax.jit(jnp.sqrt)(a), np.sqrt(a)),
        pow_is_glibc=same(jax.jit(jnp.power)(ga, gb),
                          jax.jit(jnp.power, device=jax.devices("cpu")[0])(ga, gb)),
    )


def main() -> int:
    import jax

    print(f"backend: {jax.default_backend()} ({jax.devices()[0].device_kind})")
    failed = 0
    for name, stats, allowed in run_battery():
        ok = row_ok(stats, allowed)
        failed += not ok
        print(f"{'OK  ' if ok else 'DIFF'} {name} {stats} allowed={allowed}")
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--dump":
        dump(sys.argv[2], *(int(v) for v in sys.argv[3:4]))
    else:
        sys.exit(main())
