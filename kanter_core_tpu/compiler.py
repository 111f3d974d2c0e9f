"""Whole-graph fusion compiler: dirty subgraph → ONE jitted XLA program.

This is the XLA answer to the reference's thread-per-node scheduler
(`/root/reference/src/engine.rs:288-306`): instead of evaluating a DAG node
by node with intermediate buffers, the graph is traced symbolically — every
node type maps to the same traceable kernels the eager engine uses — and
compiled by XLA into a single fused program over device-resident channel
planes. Elementwise chains (value/mix/separate/combine/invert/…) fuse into a
handful of kernels; intermediate planes that no target needs are never
materialized in device memory.

Runtime-variable leaves become program *arguments* so interactive edits skip
recompilation where possible:

- `Image` nodes: four `[H, W]` planes (decoded host-side at compile time,
  re-bindable at call time);
- `Value` nodes: f32 scalars (changing a value re-runs, not re-traces);
- `InputGray`/`InputRgba`: externally provided planes;
- `Embed`: the registered slot-data planes.

Nested `Graph` nodes are inlined at trace time (flattened into the same XLA
program) rather than scheduled as blocking sub-evaluations
(`/root/reference/src/node/graph.rs:33-48`).

Programs are cached per structure fingerprint (topology + node params +
input shapes), so incremental re-evaluation of an edited graph is a cache
hit that only re-runs the compiled executable — the <10 ms interactive path.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

import numpy as np

from .errors import ErrorKind, TexProError
from .geometry import Size
from .ids import NodeId, SlotId
from .node import NodeTypeKind
from .node_graph import NodeGraph
from .ops import image_io
from .ops.mix import _binary
from .ops.resize import calculate_size, resample_plane


def resolve_dtype(dtype):
    """Normalize a pipeline-dtype spec (None | str | dtype-like) to a numpy
    dtype object. None → float32 (the bit-exact default). Strings resolve
    through jnp so "bfloat16" maps to the ml_dtypes bfloat16 numpy dtype."""
    import jax.numpy as jnp

    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, str):
        dtype = getattr(jnp, dtype)
    return np.dtype(dtype)


class _PendingLayout(__import__("threading").local):
    """Trace-recorded plane layout, one slot PER THREAD.

    jit traces run synchronously on the calling thread, so a fast-path
    call that happens to retrace anyway (the jit cache also keys dtype /
    weak-type / sharding / placement, which the shape signature does not)
    records into ITS OWN slot instead of clobbering a locked first-trace's
    record on another thread — which would silently attribute the wrong
    layout to the new signature."""

    value: Optional[dict] = None


def call_with_pending_layout(fn, args, sig, lock, layouts, pending, err_msg,
                             on_trace=None):
    """The layout-attribution protocol shared by the dense fused compiler
    (`CompiledGraph.call_with_layout`) and the shape-bucketed twin
    (`bucketed.BucketedGraph._call_with_layout`).

    `fn` is a jitted program whose TRACE records the output plane layout
    into `pending` (a `_PendingLayout`); the layout can depend on input
    shapes (which operand a resize pass copies vs aliases), so layouts are
    kept per shape signature. The first call for a signature serializes
    under `lock` so the trace-recorded layout is attributed to the right
    signature; later calls are lock-free cache hits. `on_trace` (optional)
    runs UNDER the lock just before a possibly-tracing call — the hook for
    publishing trace-time state (e.g. the node table a retrace must read)
    without racing lock-free hit-path callers."""
    layout = layouts.get(sig)
    if layout is not None:
        return fn(args), layout
    with lock:
        layout = layouts.get(sig)
        if layout is not None:
            return fn(args), layout
        if on_trace is not None:
            on_trace()
        pending.value = None
        result = fn(args)
        layout = pending.value
        if layout is None:
            # executable was already cached under a signature alias
            # (should not happen; surface rather than mis-attribute)
            raise TexProError(ErrorKind.GENERIC, err_msg)
        layouts[sig] = layout
        return result, layout


def _topo_order(graph) -> list:
    """Iterative post-order topological sort (parents before children)."""
    order, done, in_progress = [], set(), set()
    for root in graph.nodes:
        if root.node_id in done:
            continue
        stack = [(root.node_id, False)]
        while stack:
            node_id, expanded = stack.pop()
            if node_id in done:
                continue
            if expanded:
                in_progress.discard(node_id)
                done.add(node_id)
                order.append(node_id)
                continue
            if node_id in in_progress:
                continue  # cycle guard (cannot happen in valid graphs)
            in_progress.add(node_id)
            stack.append((node_id, True))
            for parent in graph.get_parents(node_id):
                if parent not in done:
                    stack.append((parent, False))
    return order


class ImgVal:
    """A symbolic image during tracing: 1 (gray) or 4 (rgba) plane tracers."""

    __slots__ = ("planes",)

    def __init__(self, planes):
        self.planes = list(planes)

    @property
    def is_rgba(self) -> bool:
        return len(self.planes) == 4

    @property
    def size(self) -> Size:
        h, w = self.planes[0].shape
        return Size(w, h)


class _SymData:
    """SlotData shim so `calculate_size` works on tracers."""

    __slots__ = ("node_id", "slot_id", "img")

    def __init__(self, node_id, slot_id, img: ImgVal):
        self.node_id = node_id
        self.slot_id = slot_id
        self.img = img

    def size(self) -> Size:
        return self.img.size


def _const_guard(plane):
    """Barrier constant-origin planes (default fills, forced alphas).

    XLA's constant folder is NOT bit-identical to its runtime kernels: a
    compile-time-constant plane flowing through a tap-sum chain (resample,
    blur) folds to values up to 1 ulp off what the same formulas compute at
    runtime (measured: Value→H2N→resize+Blur alpha folded to 0.99999994
    where eager/tiled runtime — and Rust — give 1.0). The barrier keeps
    constant planes out of the folder so every traced consumer (fused,
    tiled, bucketed) matches the eager path's runtime bits. Eager kernels
    are safe by construction — their inputs arrive as runtime arrays."""
    from jax import lax

    return lax.optimization_barrier(plane)


def _ones_like(plane):
    import jax.numpy as jnp

    return _const_guard(jnp.ones_like(plane))


def _ones(shape):
    import jax.numpy as jnp

    return _const_guard(jnp.ones(shape, jnp.float32))


def _zeros(shape):
    import jax.numpy as jnp

    return _const_guard(jnp.zeros(shape, jnp.float32))


def _as_type(img: ImgVal, rgba: bool) -> ImgVal:
    import jax.numpy as jnp

    if img.is_rgba == rgba:
        return img
    if rgba:
        g = img.planes[0]
        return ImgVal([g, g, g, _ones_like(g)])
    # rgba→gray mean computes in f32 (bf16 pipeline upcasts, DESIGN.md §9)
    r, g, b = (
        p.astype(jnp.float32) if p.dtype != jnp.float32 else p
        for p in img.planes[:3]
    )
    s = (r + g) + b
    # /3 must round like glibc on every backend (ops/exact_math.py: the
    # GPU's divide is up to 2 ulp loose) or rgba→gray planes break the
    # cross-backend f32-bit determinism the recipe cache relies on. A plain
    # divide must be const-guarded: XLA rewrites division by a compile-time
    # constant into reciprocal-multiply (measured 6422/16384 f32-bit diffs
    # vs the reference's true division for /3)
    from .ops.exact_math import exact_div

    return ImgVal([exact_div(s, _const_guard(jnp.full_like(s, jnp.float32(3.0))))])


def _from_value(size: Size, value: float, rgba: bool) -> ImgVal:
    import jax.numpy as jnp

    shape = (size.height, size.width)
    plane = _const_guard(jnp.full(shape, jnp.float32(value), jnp.float32))
    if rgba:
        return ImgVal([plane, plane, plane, _ones(shape)])
    return ImgVal([plane])


class GraphCompiler:
    """Traces a NodeGraph into a single jittable function."""

    def __init__(self, node_graph: NodeGraph, include_u8: bool = False, preset=None,
                 pallas_ok: bool = True, mesh=None, mesh_axis=None):
        self.node_graph = node_graph
        self.include_u8 = include_u8
        # NOTE: the pipeline storage dtype (bf16 mode) lives entirely in
        # CompiledGraph (leaf uploads + output downcast) and the ops' entry
        # upcasts — the symbolic compiler is dtype-agnostic by design.
        # False when the program must avoid Pallas entirely (vmapped mesh
        # programs — Pallas custom calls aren't GSPMD-partitionable and
        # shard_map doesn't compose with the batch vmap); ops then use jnp
        # lowerings. `mesh` instead keeps kernels viable under GSPMD by
        # emitting their shard_map'd forms (ops/blur_triton.py).
        self.pallas_ok = pallas_ok
        self.mesh = mesh
        self.mesh_axis = mesh_axis  # spatial axis name for shard_map kernels
        # preset: {(NodeId, SlotId): n_planes} — nodes whose outputs are
        # already computed (clean boundary of a dirty partition); their
        # planes are program arguments instead of being re-evaluated.
        self.preset = dict(preset or {})

    # --- topo order (iterative post-order over parents) ---
    def _topo_order(self, graph: NodeGraph) -> list:
        return _topo_order(graph)

    # --- symbolic node evaluation (mirrors ops.process_node) ---
    def _eval_graph(self, graph: NodeGraph, args: dict, prefix: str,
                    outer_inputs: Optional[dict] = None) -> dict:
        """Returns {(node_id, slot_id): ImgVal} for every node in `graph`.

        `outer_inputs` maps inner Input-node NodeId → ImgVal (for inlined
        subgraphs, `graph.rs:25-31`); `prefix` namespaces argument keys of
        nested graphs.
        """
        values: dict = {}
        ordered_outer = (
            [outer_inputs[k] for k in sorted(outer_inputs)] if outer_inputs else []
        )

        preset_nodes = (
            {nid for nid, _ in self.preset} if (self.preset and prefix == "") else set()
        )

        for node_id in self._topo_order(graph):
            if node_id in preset_nodes:
                for (nid, slot), _count in self.preset.items():
                    if nid == node_id:
                        values[(nid, slot)] = ImgVal(
                            list(args[f"preset_{int(nid)}_{int(slot)}"])
                        )
                continue
            node = graph.node(node_id)
            # The eager path gathers inputs in edge INSERTION order and only
            # sorts the edge list (`node_type.rs:229-236`), so MostPixels/
            # LeastPixels pixel-count ties resolve by insertion order — the
            # traced path must match exactly (fused == per-node bit parity).
            edges_ins = [e for e in graph.edges if e.input_id == node_id]
            edges_sorted = sorted(edges_ins, key=lambda e: e.input_slot)
            inputs = [
                _SymData(e.output_id, e.output_slot, values[(e.output_id, e.output_slot)])
                for e in edges_ins
            ]

            # resize pass (`shared.rs:141-216`)
            if inputs:
                size = calculate_size(inputs, edges_sorted, node.resize_policy)
                inputs = [
                    _SymData(
                        sd.node_id,
                        sd.slot_id,
                        ImgVal(
                            [resample_plane(p, size, node.resize_filter) for p in sd.img.planes]
                        )
                        if sd.size() != size
                        else sd.img,
                    )
                    for sd in inputs
                ]
            # re-key to consumer slots (`node_type.rs:250-267`): first input
            # matching the edge's producer key, like `assign_slot_ids`
            by_slot = {}
            for edge in edges_sorted:
                for sd in inputs:
                    if sd.node_id == edge.output_id and sd.slot_id == edge.output_slot:
                        by_slot[edge.input_slot] = sd.img
                        break

            for slot_id, img in self._emit(node, by_slot, args, prefix, graph, ordered_outer):
                values[(node_id, slot_id)] = img
        return values

    def _emit(self, node, by_slot: dict, args, prefix, graph, ordered_outer):
        import jax.numpy as jnp

        K = NodeTypeKind
        kind = node.node_type.kind
        nid = int(node.node_id)

        if kind == K.VALUE:
            # scalar program argument → 1×1 plane
            val = args[f"{prefix}value_{nid}"]
            return [(SlotId(0), ImgVal([jnp.reshape(jnp.asarray(val, jnp.float32), (1, 1))]))]

        if kind == K.IMAGE:
            planes = args[f"{prefix}image_{nid}"]
            return [(SlotId(0), ImgVal(list(planes)))]

        if kind in (K.INPUT_GRAY, K.INPUT_RGBA):
            if kind == K.INPUT_RGBA:
                if ordered_outer:
                    img = ordered_outer[0]  # reference indexes [0] (`input_rgba.rs:7-13`)
                elif f"{prefix}input_rgba_first" in args:
                    img = args[f"{prefix}input_rgba_first"]
                else:
                    raise TexProError(ErrorKind.NODE_PROCESSING, "InputRgba with no outer input")
            else:
                key = f"{prefix}input_{nid}"
                if key not in args:
                    raise TexProError(
                        ErrorKind.INVALID_BUFFER_COUNT,
                        f"InputGray node {nid} has no bound input",
                    )
                img = args[key]
            if not isinstance(img, ImgVal):
                img = ImgVal(list(img))  # externally bound plane tuple
            return [(SlotId(0), img)]

        if kind in (K.OUTPUT_GRAY, K.OUTPUT_RGBA):
            if by_slot:
                return [(SlotId(0), by_slot[min(by_slot)])]
            if kind == K.OUTPUT_RGBA:
                z = _zeros((1, 1))
                return [(SlotId(0), ImgVal([z, z, z, _ones((1, 1))]))]
            return [(SlotId(0), ImgVal([_zeros((1, 1))]))]

        if kind == K.MIX:
            left, right = by_slot.get(SlotId(0)), by_slot.get(SlotId(1))
            mix_type = node.node_type.payload
            if left is not None:
                rgba = left.is_rgba
                right = (
                    _as_type(right, rgba)
                    if right is not None
                    else _from_value(left.size, 0.0, rgba)
                )
            elif right is not None:
                left = _from_value(right.size, 0.0, right.is_rgba)
            else:
                return [(SlotId(0), ImgVal([_zeros((1, 1))]))]
            op = _binary(mix_type)
            if left.is_rgba:
                planes = [op(left.planes[i], right.planes[i]) for i in range(3)]
                planes.append(_ones_like(planes[0]))
            else:
                planes = [op(left.planes[0], right.planes[0])]
            return [(SlotId(0), ImgVal(planes))]

        if kind == K.HEIGHT_TO_NORMAL:
            from .ops.height_to_normal import h2n_traceable

            inp = by_slot.get(SlotId(0))
            if inp is None or inp.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "HeightToNormal needs a Gray input"
                )
            outs = h2n_traceable(inp.planes[0])
            return [(SlotId(0), ImgVal(list(outs)))]

        if kind == K.HSV:
            from .ops.hsv import hsv_planes

            inp = by_slot.get(SlotId(0))
            if inp is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Hsv needs an input"
                )
            params = args[f"{prefix}hsv_{nid}"]
            return [(SlotId(0), ImgVal(hsv_planes(inp.planes, params)))]

        if kind == K.CURVATURE:
            from .ops.curvature import curvature_plane

            inp = by_slot.get(SlotId(0))
            if inp is None or inp.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Curvature needs a Gray input"
                )
            strength = args[f"{prefix}curv_{nid}"]
            return [(SlotId(0), ImgVal([curvature_plane(inp.planes[0], strength)]))]

        if kind == K.DISTANCE:
            from .ops.distance import distance_plane

            inp = by_slot.get(SlotId(0))
            if inp is None or inp.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT,
                    "Distance needs a Gray input",
                )
            max_dist = args[f"{prefix}dist_{nid}"]
            return [(
                SlotId(0),
                ImgVal([distance_plane(inp.planes[0], max_dist)]),
            )]

        if kind == K.AMBIENT_OCCLUSION:
            from .ops.ambient_occlusion import ao_plane

            inp = by_slot.get(SlotId(0))
            if inp is None or inp.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT,
                    "AmbientOcclusion needs a Gray input",
                )
            strength = args[f"{prefix}ao_{nid}"]
            radius = node.node_type.payload[1]
            return [(
                SlotId(0),
                ImgVal([ao_plane(
                    inp.planes[0], strength, radius,
                    pallas_ok=self.pallas_ok, mesh=self.mesh,
                    mesh_axis=self.mesh_axis,
                )]),
            )]

        if kind == K.BLUR:
            from .ops.blur import blur_plane

            inp = by_slot.get(SlotId(0))
            if inp is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Blur needs an input"
                )
            sigma = node.node_type.payload
            return [(
                SlotId(0),
                ImgVal([
                    blur_plane(p, sigma, pallas_ok=self.pallas_ok,
                               mesh=self.mesh, mesh_axis=self.mesh_axis)
                    for p in inp.planes
                ]),
            )]

        if kind == K.LEVELS:
            from .ops.levels import levels_plane

            inp = by_slot.get(SlotId(0))
            if inp is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Levels needs an input"
                )
            params = args[f"{prefix}levels_{nid}"]
            return [(
                SlotId(0),
                ImgVal([levels_plane(p, params) for p in inp.planes]),
            )]

        if kind == K.NOISE:
            from .ops.noise import noise_plane

            b = args[f"{prefix}noise_{nid}"]
            return [(
                SlotId(0),
                ImgVal([noise_plane(
                    b["rows"], b["cols"], b["seed"], b["persistence"],
                    b["fx"], b["fy"], b["periods"],
                )]),
            )]

        if kind == K.PATTERN:
            from .ops.pattern import pattern_planes

            b = args[f"{prefix}pattern_{nid}"]
            mask, cells = pattern_planes(
                node.node_type.payload[2],  # kind is static: shapes the trace
                b["rows"], b["cols"], b["fx"], b["fy"], b["px"], b["py"],
                b["mortar"], b["bevel"], b["seed"],
            )
            return [
                (SlotId(0), ImgVal([mask])),
                (SlotId(1), ImgVal([cells])),
            ]

        if kind == K.VORONOI:
            from .ops.voronoi import voronoi_planes

            b = args[f"{prefix}voronoi_{nid}"]
            distance, borders, cells = voronoi_planes(
                b["rows"], b["cols"], b["fx"], b["fy"], b["px"], b["py"],
                b["jitter"], b["seed"],
            )
            return [
                (SlotId(0), ImgVal([distance])),
                (SlotId(1), ImgVal([borders])),
                (SlotId(2), ImgVal([cells])),
            ]

        if kind == K.RAMP:
            from .ops.ramp import ramp_plane

            b = args[f"{prefix}ramp_{nid}"]
            return [(
                SlotId(0),
                ImgVal([ramp_plane(
                    node.node_type.payload[2],  # kind is static
                    b["rows"], b["cols"], b["iw"], b["ih"], b["k"],
                )]),
            )]

        if kind == K.GRADIENT_MAP:
            from .ops.gradient import gradient_planes

            inp = by_slot.get(SlotId(0))
            if inp is None or inp.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "GradientMap needs a Gray input"
                )
            b = args[f"{prefix}grad_{nid}"]
            outs = gradient_planes(inp.planes[0], b["pos"], b["colors"])
            return [(SlotId(0), ImgVal(list(outs)))]

        if kind == K.TRANSFORM:
            import numpy as _np

            from .ops.transform import transform_planes

            inp = by_slot.get(SlotId(0))
            if inp is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Transform needs an input"
                )
            b = args[f"{prefix}xform_{nid}"]
            h, w = inp.planes[0].shape
            outs = transform_planes(
                inp.planes,
                _np.arange(h, dtype=_np.int32), _np.arange(w, dtype=_np.int32),
                b["cs"], b["inv_s"], b["off"], h, w,
            )
            return [(SlotId(0), ImgVal(list(outs)))]

        if kind == K.WARP:
            import numpy as _np

            from .ops.warp import warp_planes

            inp = by_slot.get(SlotId(0))
            if inp is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Warp needs an input"
                )
            strength = by_slot.get(SlotId(1))
            if strength is None:
                # dangling strength ⇒ pass-through ALIAS (same ImgVal planes)
                return [(SlotId(0), inp)]
            b = args[f"{prefix}warp_{nid}"]
            h, w = inp.planes[0].shape
            from .ops.warp import warp_halo

            halo = warp_halo(node.node_type.payload[1])
            if self.mesh is not None:
                # bounded displacement keeps the gather shard-local: ring
                # halo exchange instead of GSPMD all-gathering every plane
                from .ops.warp import fits_mesh, warp_planes_mesh

                axis = self.mesh_axis or self.mesh.axis_names[0]
                if fits_mesh(h, int(self.mesh.shape[axis]), halo):
                    outs = warp_planes_mesh(
                        inp.planes, strength.planes[0], b["k"],
                        self.mesh, axis, halo, h, w,
                    )
                    return [(SlotId(0), ImgVal(list(outs)))]
            outs = warp_planes(
                inp.planes, strength.planes[0],
                _np.arange(h, dtype=_np.int32), _np.arange(w, dtype=_np.int32),
                b["k"], h, w,
            )
            return [(SlotId(0), ImgVal(list(outs)))]

        if kind == K.SEPARATE_RGBA:
            inp = by_slot.get(SlotId(0))
            if inp is not None and inp.is_rgba:
                return [(SlotId(i), ImgVal([inp.planes[i]])) for i in range(4)]
            return [(SlotId(i), ImgVal([_zeros((1, 1))])) for i in range(4)]

        if kind == K.COMBINE_RGBA:
            size = by_slot[min(by_slot)].size if by_slot else Size(1, 1)
            shape = (size.height, size.width)
            shared_zero = None

            def color(slot):
                nonlocal shared_zero
                img = by_slot.get(SlotId(slot))
                if img is not None:
                    if img.is_rgba:
                        # matches the eager op's fatal error
                        # (`combine_rgba.rs:22-25`, separate_combine.py)
                        raise TexProError(
                            ErrorKind.INVALID_SLOT_TYPE,
                            "RGBA image connected to a CombineRgba input slot",
                        )
                    return img.planes[0]
                if shared_zero is None:
                    shared_zero = _zeros(shape)
                return shared_zero

            alpha_img = by_slot.get(SlotId(3))
            if alpha_img is not None and alpha_img.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_SLOT_TYPE,
                    "RGBA image connected to a CombineRgba input slot",
                )
            alpha = alpha_img.planes[0] if alpha_img is not None else _ones(shape)
            return [(SlotId(0), ImgVal([color(0), color(1), color(2), alpha]))]

        if kind == K.GRAPH:
            nested = node.node_type.payload
            # outer input slot id n ≡ inner Input node id n (`node_graph.rs:271-313`)
            outer_map = {NodeId(int(slot)): img for slot, img in by_slot.items()}
            nested_args = dict(args)
            # bind inner InputGray nodes from the outer edges
            for inner_id, img in outer_map.items():
                nested_args[f"{prefix}g{nid}_input_{int(inner_id)}"] = img
            nested_prefix = f"{prefix}g{nid}_"
            nested_values = self._eval_graph(nested, nested_args, nested_prefix, outer_map)
            outputs = []
            for output_node_id in nested.output_ids():
                img = nested_values[(output_node_id, SlotId(0))]
                outputs.append((SlotId(int(output_node_id)), img))
            return outputs

        if kind == K.EMBED:
            planes = args.get(f"{prefix}embed_{int(node.node_type.payload)}")
            if planes is None:
                # no data registered under this id: diagnosable graph error,
                # not a raw KeyError the engine would treat as fatal
                # (reference: `embed.rs:33-50` returns Err; found by the
                # r5 payload fuzz)
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT,
                    f"no embedded slot data with id "
                    f"{int(node.node_type.payload)}",
                )
            return [(SlotId(0), ImgVal(list(planes)))]

        if kind == K.WRITE:
            return []  # host-side sink; not representable in a fused program

        raise TexProError(ErrorKind.INVALID_NODE_TYPE, f"cannot fuse {node.node_type!r}")


class CompiledGraph:
    """A compiled, reusable evaluation program for a node graph.

    `targets` selects which (node_id, slot_id) outputs to materialize; XLA
    dead-code-eliminates everything not needed for them.
    """

    def __init__(
        self,
        node_graph: NodeGraph,
        targets: Optional[list[tuple]] = None,
        include_u8: bool = False,
        preset=None,
        emit_all: bool = False,
        pallas_ok: bool = True,
        mesh=None,
        mesh_axis=None,
        dtype=None,
    ):
        import jax

        # pipeline STORAGE dtype (DESIGN.md §9). float32 (default) is the
        # bit-exact reference pipeline; bfloat16 is the opt-in half-precision
        # mode: bf16 AT REST, f32 IN FLIGHT. Leaves (image/input/embed/
        # preset planes) are stored and uploaded at bf16 (`_collect_bindings`
        # / `bind_input` / `bind_preset` / `bind_embed`); every COMPUTE op
        # upcasts its operands with a FRESH convert per consumer (inside
        # `_binary`/`resample_plane`/`blur_plane`/`_h2n_jnp`/`levels_plane`
        # — a shared upcast tracer makes XLA materialize the f32 copy,
        # measured costlier than the bf16 read savings), so op math runs
        # f32 exactly like the default pipeline and the exact-math
        # machinery stays engaged. ALIASING ops (Output/Separate/Combine/
        # Graph re-keying) pass stored planes through untouched, and only
        # committed outputs downcast once (`fn`'s `store` below).
        self.dtype = resolve_dtype(dtype)
        self.node_graph = node_graph
        self.preset = dict(preset or {})
        self.emit_all = emit_all
        if emit_all:
            targets = []
        elif targets is None:
            targets = [(nid, SlotId(0)) for nid in node_graph.output_ids()]
            if not targets:
                # default: every terminal node's slot-0 output
                with_children = {e.output_id for e in node_graph.edges}
                targets = [
                    (n.node_id, SlotId(0))
                    for n in node_graph.nodes
                    if n.node_id not in with_children
                    and n.node_type.kind != NodeTypeKind.WRITE
                ]
        self.targets = [(NodeId(n), SlotId(s)) for n, s in targets]
        self.include_u8 = include_u8

        self._compiler = GraphCompiler(
            node_graph, include_u8, preset=self.preset, pallas_ok=pallas_ok,
            mesh=mesh, mesh_axis=mesh_axis,
        )
        self._bindings = self._collect_bindings(node_graph, prefix="")

        preset_node_ids = {nid for nid, _ in self.preset}
        # emit_all mode: {key: (unique_plane_index, ...)} — plane aliasing
        # across outputs (SeparateRgba, as_type, Output re-keying) is
        # preserved by deduplicating identical tracers at trace time, exactly
        # like the reference's Arc-shared channel planes. The aliasing
        # structure can depend on input *shapes* (which operand a resize pass
        # copies vs aliases), so layouts are kept per shape signature
        # (`call_with_layout`) — never a single mutable attribute a retrace
        # could clobber for other shapes/threads.
        self._layouts: dict = {}  # shape signature → layout dict
        self._pending_layout = _PendingLayout()
        self._trace_lock = __import__("threading").Lock()

        def fn(bound_args: dict):
            values = self._compiler._eval_graph(node_graph, dict(bound_args), "")
            # outputs leave the program at the STORAGE dtype (bf16 mode:
            # one downcast per unique plane; f32 default: identity). u8
            # exports convert from the f32 in-flight value directly — no
            # precision lost to the storage rounding.
            down: dict = {}  # id(f32 tracer) → storage tracer, aliasing-safe

            def store(plane):
                if plane.dtype == self.dtype:
                    return plane
                key = id(plane)
                if key not in down:
                    down[key] = plane.astype(self.dtype)
                return down[key]

            out = {}
            if self.emit_all:
                unique: dict = {}  # id(tracer) → (index, tracer)
                layout: dict = {}
                for key, img in values.items():
                    if key[0] in preset_node_ids:
                        continue
                    idxs = []
                    for plane in img.planes:
                        pid = id(plane)
                        if pid not in unique:
                            unique[pid] = (len(unique), plane)
                        idxs.append(unique[pid][0])
                    layout[key] = tuple(idxs)
                self._pending_layout.value = layout
                ordered = sorted(unique.values(), key=lambda iv: iv[0])
                return tuple(store(plane) for _, plane in ordered)
            for key in self.targets:
                img = values[key]
                if include_u8:
                    out[key] = _u8_export(img)
                else:
                    out[key] = tuple(store(p) for p in img.planes)
            return out

        # NOT donated: every plane argument is owned by a live PlaneBuffer
        # (boundary/embed/input slot datas) or reused across interactive
        # re-runs (image bindings), so input-output aliasing would free
        # buffers the engine still reads. Donation lives where buffers are
        # genuinely one-shot: the tiled evaluator's band arguments
        # (`tiled.TiledEvaluator`).
        self._raw_fn = fn  # un-jitted traceable fn (vmap/shard composition)
        self._fn = jax.jit(fn)

    @staticmethod
    def _shape_signature(args: dict):
        import jax

        sig = []
        for key in sorted(args):
            shapes = tuple(
                getattr(leaf, "shape", ()) for leaf in jax.tree.leaves(args[key])
            )
            sig.append((key, shapes))
        return tuple(sig)

    def call_with_layout(self, **overrides):
        """emit_all evaluation returning `(unique_planes, layout)` where
        `layout` maps `(node_id, slot_id) → (unique_plane_index, ...)` for
        exactly the shapes of this call."""
        assert self.emit_all
        args = dict(self._bindings)
        args.update(overrides)
        sig = self._shape_signature(args)
        return call_with_pending_layout(
            self._fn, args, sig, self._trace_lock, self._layouts,
            self._pending_layout,
            "fused program produced no layout for new shapes",
        )

    # --- default argument binding from node params / files ---
    def _collect_bindings(self, graph: NodeGraph, prefix: str) -> dict:
        import jax.numpy as jnp

        bindings: dict = {}
        K = NodeTypeKind
        preset_node_ids = {int(nid) for nid, _ in self.preset} if prefix == "" else set()
        for node in graph.nodes:
            nid = int(node.node_id)
            if nid in preset_node_ids:
                continue  # outputs are provided, don't decode/bind leaves
            kind = node.node_type.kind
            if kind == K.VALUE:
                bindings[f"{prefix}value_{nid}"] = np.float32(node.node_type.payload)
            elif kind == K.LEVELS:
                bindings[f"{prefix}levels_{nid}"] = np.asarray(
                    node.node_type.payload, np.float32
                )
            elif kind == K.CURVATURE:
                bindings[f"{prefix}curv_{nid}"] = np.float32(node.node_type.payload)
            elif kind == K.AMBIENT_OCCLUSION:
                bindings[f"{prefix}ao_{nid}"] = np.float32(node.node_type.payload[0])
            elif kind == K.DISTANCE:
                bindings[f"{prefix}dist_{nid}"] = np.float32(node.node_type.payload)
            elif kind == K.HSV:
                from .ops.hsv import hsv_bindings

                bindings[f"{prefix}hsv_{nid}"] = hsv_bindings(node.node_type.payload)
            elif kind == K.NOISE:
                from .ops.noise import noise_bindings

                bindings[f"{prefix}noise_{nid}"] = noise_bindings(
                    node.node_type.payload
                )
            elif kind == K.PATTERN:
                from .ops.pattern import pattern_bindings

                bindings[f"{prefix}pattern_{nid}"] = pattern_bindings(
                    node.node_type.payload
                )
            elif kind == K.VORONOI:
                from .ops.voronoi import voronoi_bindings

                bindings[f"{prefix}voronoi_{nid}"] = voronoi_bindings(
                    node.node_type.payload
                )
            elif kind == K.RAMP:
                from .ops.ramp import ramp_bindings

                bindings[f"{prefix}ramp_{nid}"] = ramp_bindings(
                    node.node_type.payload
                )
            elif kind == K.GRADIENT_MAP:
                from .ops.gradient import gradient_bindings

                bindings[f"{prefix}grad_{nid}"] = gradient_bindings(
                    node.node_type.payload
                )
            elif kind == K.TRANSFORM:
                from .ops.transform import transform_bindings

                bindings[f"{prefix}xform_{nid}"] = transform_bindings(
                    node.node_type.payload
                )
            elif kind == K.WARP:
                from .ops.warp import warp_bindings

                bindings[f"{prefix}warp_{nid}"] = warp_bindings(
                    node.node_type.payload
                )
            elif kind == K.IMAGE:
                try:
                    slot_image = image_io.read_slot_image(node.node_type.payload)
                except TexProError:
                    slot_image = image_io.magenta_placeholder()
                # leaves upload AT the pipeline dtype (not cast in-program):
                # the device arrays themselves are half-size in bf16 mode,
                # which is where the read-bandwidth win comes from
                bindings[f"{prefix}image_{nid}"] = tuple(
                    jnp.asarray(p.host_data(), self.dtype) for p in slot_image.planes
                )
            elif kind == K.GRAPH:
                bindings.update(
                    self._collect_bindings(node.node_type.payload, f"{prefix}g{nid}_")
                )
        return bindings

    def bind_embed(self, embedded_slot_data_id, planes) -> None:
        import jax.numpy as jnp

        self._bindings[f"embed_{int(embedded_slot_data_id)}"] = tuple(
            jnp.asarray(p, self.dtype) for p in planes
        )

    def bind_input(self, input_node_id, planes, prefix: str = "") -> None:
        import jax.numpy as jnp

        self._bindings[f"{prefix}input_{int(input_node_id)}"] = tuple(
            jnp.asarray(p, self.dtype) for p in planes
        )

    def bind_input_rgba(self, planes, prefix: str = "") -> None:
        """Bind the graph's FIRST outer input (InputRgba semantics — the
        reference indexes `input_slot_datas[0]`, `input_rgba.rs:7-13`)."""
        import jax.numpy as jnp

        self._bindings[f"{prefix}input_rgba_first"] = tuple(
            jnp.asarray(p, self.dtype) for p in planes
        )

    def set_value(self, node_id, value: float, prefix: str = "") -> None:
        """Re-bind a Value node without recompiling. Raises on a non-Value
        node id — a silently unused binding would make edits no-ops."""
        key = f"{prefix}value_{int(node_id)}"
        if key not in self._bindings:
            raise TexProError(
                ErrorKind.INVALID_NODE_TYPE,
                f"{key} is not a Value binding of this program",
            )
        self._bindings[key] = np.float32(value)

    def __call__(self, **overrides):
        args = dict(self._bindings)
        args.update(overrides)
        return self._fn(args)


def _u8_export(img: ImgVal):
    import jax.numpy as jnp

    from .ops.common import f32_to_u8  # the one canonical conversion

    if img.is_rgba:
        return jnp.stack([f32_to_u8(p) for p in img.planes], axis=-1)
    v = f32_to_u8(img.planes[0])
    return jnp.stack([v, v, v, jnp.full_like(v, 255)], axis=-1)


def _normalize_values(graph_json):
    """Zero out Value and Levels payloads, and Noise's argument-borne
    fields (`cells`/`seed`/`persistence` — `width`/`height`/`octaves` shape
    the trace and stay): they are program *arguments*, so two graphs
    differing only in those constants share one compiled program (the
    interactive slider-drag case must not retrace per tick)."""
    zero_levels = {
        "in_lo": 0.0, "in_hi": 0.0, "gamma": 0.0, "out_lo": 0.0, "out_hi": 0.0,
    }
    out = {"nodes": [], "edges": graph_json["edges"]}
    for node in graph_json["nodes"]:
        node_type = node["node_type"]
        if isinstance(node_type, dict):
            if "Value" in node_type:
                node = dict(node, node_type={"Value": 0.0})
            elif "Levels" in node_type:
                node = dict(node, node_type={"Levels": zero_levels})
            elif "Curvature" in node_type:
                node = dict(node, node_type={"Curvature": 0.0})
            elif "AmbientOcclusion" in node_type:
                # strength is an argument; radius bakes the taps and stays
                node = dict(node, node_type={"AmbientOcclusion": dict(
                    node_type["AmbientOcclusion"], strength=0.0,
                )})
            elif "Distance" in node_type:
                node = dict(node, node_type={"Distance": 0.0})
            elif "Hsv" in node_type:
                node = dict(node, node_type={"Hsv": {
                    "hue": 0.0, "saturation": 0.0, "value": 0.0,
                }})
            elif "Noise" in node_type:
                node = dict(node, node_type={"Noise": dict(
                    node_type["Noise"], cells=0, seed=0, persistence=0.0,
                )})
            elif "Pattern" in node_type:
                # cells/mortar/bevel/seed are arguments; width/height/pattern
                # shape the trace and stay
                node = dict(node, node_type={"Pattern": dict(
                    node_type["Pattern"], cells_x=0, cells_y=0,
                    mortar=0.0, bevel=0.0, seed=0,
                )})
            elif "Voronoi" in node_type:
                # cells/jitter/seed are arguments; width/height shape the
                # trace and stay
                node = dict(node, node_type={"Voronoi": dict(
                    node_type["Voronoi"], cells_x=0, cells_y=0,
                    jitter=0.0, seed=0,
                )})
            elif "Ramp" in node_type:
                # angle/center/scale are arguments; width/height/kind
                # shape the trace and stay
                node = dict(node, node_type={"Ramp": dict(
                    node_type["Ramp"], angle=0.0, cx=0.0, cy=0.0, scale=0.0,
                )})
            elif "GradientMap" in node_type:
                # stop VALUES are arguments; the COUNT shapes the trace
                node = dict(node, node_type={"GradientMap": {
                    "stops": [[0.0] * 5] * len(node_type["GradientMap"]["stops"]),
                }})
            elif "Transform" in node_type:
                node = dict(node, node_type={"Transform": {
                    "offset_x": 0.0, "offset_y": 0.0, "rotation": 0.0,
                    "scale_x": 0.0, "scale_y": 0.0,
                }})
            elif "Warp" in node_type:
                # angle and intensity are arguments, but the HALO BUCKET is
                # structure: tiled band row sets and the mesh shard_map bake
                # it into the trace (ops/warp.py::warp_halo), so an
                # intensity drag reuses programs within its bucket and
                # retraces exactly once when it crosses one (-1 ⇒ unbounded)
                from .ops.warp import warp_halo

                halo = warp_halo(node_type["Warp"]["intensity"])
                node = dict(node, node_type={"Warp": {
                    "angle": 0.0,
                    "intensity": -1.0 if halo is None else float(halo),
                }})
            elif "Graph" in node_type:
                node = dict(node, node_type={"Graph": _normalize_values(node_type["Graph"])})
        out["nodes"].append(node)
    return out


def graph_fingerprint(node_graph: NodeGraph, extra: str = "") -> str:
    """Structure hash for program caching: topology + params + sizes.
    Value-node constants are excluded (see `_normalize_values`)."""
    blob = json.dumps(_normalize_values(node_graph.to_json()), sort_keys=True) + extra
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def collect_image_bindings(
    node_graph: NodeGraph, node_ids=None, prefix: str = "", dtype=None
) -> dict:
    """Freshly decoded planes for Image nodes (optionally restricted to
    `node_ids` at the top level). A dirtied Image node must re-read its file
    like the eager op does (`image.rs:11-19`) — cached program bindings hold
    the pixels from compile time. `dtype` is the pipeline STORAGE dtype:
    leaves upload at it (bf16 mode halves leaf transfer/HBM bytes and keeps
    the fused engine path's leaf quantization identical to the per-node
    route's commits — kernels upcast at entry, f32 in flight)."""
    import jax.numpy as jnp

    dtype = resolve_dtype(dtype)
    bindings = {}
    for node in node_graph.nodes:
        kind = node.node_type.kind
        if kind == NodeTypeKind.IMAGE:
            if prefix == "" and node_ids is not None and node.node_id not in node_ids:
                continue
            try:
                slot_image = image_io.read_slot_image(node.node_type.payload)
            except TexProError:
                slot_image = image_io.magenta_placeholder()
            bindings[f"{prefix}image_{int(node.node_id)}"] = tuple(
                jnp.asarray(p.host_data(), dtype) for p in slot_image.planes
            )
        elif kind == NodeTypeKind.GRAPH:
            bindings.update(
                collect_image_bindings(
                    node.node_type.payload,
                    None,
                    f"{prefix}g{int(node.node_id)}_",
                    dtype=dtype,
                )
            )
    return bindings


def collect_value_bindings(node_graph: NodeGraph, prefix: str = "") -> dict:
    """Current Value payloads as program-argument overrides (recursing into
    nested graphs)."""
    bindings = {}
    for node in node_graph.nodes:
        kind = node.node_type.kind
        if kind == NodeTypeKind.VALUE:
            bindings[f"{prefix}value_{int(node.node_id)}"] = np.float32(node.node_type.payload)
        elif kind == NodeTypeKind.LEVELS:
            bindings[f"{prefix}levels_{int(node.node_id)}"] = np.asarray(
                node.node_type.payload, np.float32
            )
        elif kind == NodeTypeKind.CURVATURE:
            bindings[f"{prefix}curv_{int(node.node_id)}"] = np.float32(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.AMBIENT_OCCLUSION:
            bindings[f"{prefix}ao_{int(node.node_id)}"] = np.float32(
                node.node_type.payload[0]
            )
        elif kind == NodeTypeKind.DISTANCE:
            bindings[f"{prefix}dist_{int(node.node_id)}"] = np.float32(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.HSV:
            from .ops.hsv import hsv_bindings

            bindings[f"{prefix}hsv_{int(node.node_id)}"] = hsv_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.NOISE:
            from .ops.noise import noise_bindings

            bindings[f"{prefix}noise_{int(node.node_id)}"] = noise_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.PATTERN:
            from .ops.pattern import pattern_bindings

            bindings[f"{prefix}pattern_{int(node.node_id)}"] = pattern_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.VORONOI:
            from .ops.voronoi import voronoi_bindings

            bindings[f"{prefix}voronoi_{int(node.node_id)}"] = voronoi_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.RAMP:
            from .ops.ramp import ramp_bindings

            bindings[f"{prefix}ramp_{int(node.node_id)}"] = ramp_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.GRADIENT_MAP:
            from .ops.gradient import gradient_bindings

            bindings[f"{prefix}grad_{int(node.node_id)}"] = gradient_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.TRANSFORM:
            from .ops.transform import transform_bindings

            bindings[f"{prefix}xform_{int(node.node_id)}"] = transform_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.WARP:
            from .ops.warp import warp_bindings

            bindings[f"{prefix}warp_{int(node.node_id)}"] = warp_bindings(
                node.node_type.payload
            )
        elif kind == NodeTypeKind.GRAPH:
            bindings.update(
                collect_value_bindings(
                    node.node_type.payload, f"{prefix}g{int(node.node_id)}_"
                )
            )
    return bindings


from collections import OrderedDict

_PROGRAM_CACHE: OrderedDict = OrderedDict()
_PROGRAM_CACHE_CAP = 128  # LRU bound: compiled programs pin executables + decoded planes


def compile_graph(
    node_graph: NodeGraph,
    targets: Optional[list[tuple]] = None,
    include_u8: bool = False,
    cache: bool = True,
    dtype=None,
) -> CompiledGraph:
    """Compile (with caching) a node graph into a fused program.

    Cache hits return a shallow handle sharing the jitted executable but
    owning its bindings, so refreshing Value constants for one caller never
    mutates a handle previously returned to another.

    `dtype` selects the pipeline storage dtype (DESIGN.md §9): None/float32
    is the bit-exact default, "bfloat16" the half-precision mode."""
    dtype = resolve_dtype(dtype)
    key = None
    if cache:
        key = (
            graph_fingerprint(
                node_graph,
                # `targets is None` (default outputs) must not share a key
                # with an explicit empty list (a program that computes
                # nothing) — a bare falsy check collided them
                extra="default" if targets is None else repr(sorted(targets)),
            ),
            include_u8,
            dtype.name,
        )
        hit = _PROGRAM_CACHE.get(key)
        if hit is not None:
            _PROGRAM_CACHE.move_to_end(key)
            import copy

            handle = copy.copy(hit)
            handle._bindings = dict(hit._bindings)
            handle._bindings.update(collect_value_bindings(node_graph))
            return handle
    program = CompiledGraph(node_graph, targets, include_u8, dtype=dtype)
    if cache:
        _PROGRAM_CACHE[key] = program
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.popitem(last=False)
    return program
