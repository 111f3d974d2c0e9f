"""Shape-bucketed interactive evaluation: size drags compile per BUCKET.

SURVEY §7 hard-part 2 / VERDICT r2 missing #5: dragging a canvas size
(editing a `ResizePolicy.SpecificSize` payload, the reference's
`node/mod.rs:33-47` target-size mechanism) changes plane shapes, and XLA
compiles per shape — at seconds per compile, a 1000→1400 px drag meant
~400 compiles. Here every computed
node's plane is PADDED to a size bucket and all size-dependent data
movement rides in program *arguments*:

- every inter-node edge is mediated by host-computed gather indices
  (`g_`/`c_` row/column pads) or resample tap indices + weights
  (`ri_`/`rw_`/`ci_`/`cw_`, exactly `ops.resize.resample_weights`' output,
  zero-padded in the tap dimension — the production `_apply_axis0` already
  masks zero-weight taps, so padding taps is the SAME transformation the
  golden-proven kernels perform);
- wrap stencils gather their toroidal neighbors through index arguments
  computed from the TRUE size (`u_`/`hl_` for HeightToNormal — the tiled
  evaluator's parity-proven gather formulation — and `bv_`/`bh_` for Blur);
- texel-step scalars (1/width) are computed host-side and passed as f32
  scalar arguments (an on-device division is ~1 ulp loose on the GPU).

Pad regions are never read: gathers index only true rows/columns, and
garbage propagates harmlessly through elementwise ops until the final
[:true_h, :true_w] slice. Two sizes in the same bucket therefore produce
identical argument SHAPES → one jitted executable serves the whole bucket,
and a drag costs one compile per bucket crossed (`traces` counts them).

Bit-exactness: every op re-uses the lockstep twins (`_apply_axis0_indexed`,
`_h2n_core`, `mix._binary`, the blur tap loop), so output planes are
bit-identical to `compiler.CompiledGraph` — `tests/test_bucketed.py`
fuzzes the equivalence. This is the FOURTH consumer of the op set
(CLAUDE.md: eager / fused / tiled / bucketed stay in lockstep).

Scope: the tileable op set; nested Graph nodes are auto-flattened at
construction (the tiled flattener), Write sinks are out (never fused);
topology or plane-count changes require a new `BucketedGraph` (size edits
do not).
"""

from __future__ import annotations

import numpy as np

from .errors import ErrorKind, TexProError
from .geometry import Size
from .ids import NodeId, SlotId
from .node import NodeTypeKind
from .ops.resize import resample_weights

K = NodeTypeKind

#: kinds the bucketed trace supports (Graph must be pre-flattened)
BUCKETABLE_KINDS = frozenset(
    {
        K.VALUE, K.IMAGE, K.INPUT_GRAY, K.INPUT_RGBA, K.EMBED,
        K.OUTPUT_GRAY, K.OUTPUT_RGBA, K.MIX, K.HEIGHT_TO_NORMAL, K.CURVATURE,
        K.AMBIENT_OCCLUSION, K.BLUR,
        K.LEVELS, K.HSV, K.NOISE, K.PATTERN, K.VORONOI, K.RAMP,
        K.GRADIENT_MAP,
        K.TRANSFORM,
        K.WARP,
        K.SEPARATE_RGBA, K.COMBINE_RGBA,
    }
)

_LEAF_KINDS = frozenset({K.IMAGE, K.EMBED, K.INPUT_GRAY, K.INPUT_RGBA})

#: the default pad-bucket size. The engine's segmented dispatch pads
#: inter-segment boundary planes to THIS bucket's targets
#: (`engine._eval_bucketed_segments`) — the two must agree or pleaf arg
#: shapes mismatch the trace, so both read this one constant.
DEFAULT_BUCKET = 256


def graph_is_bucketable(graph, preset_nodes=frozenset(),
                        allow_graph: bool = False) -> bool:
    """True if every (non-preset) node kind has a padded-trace twin —
    the engine's `_try_bucketed` gate (mirrors `tiled.graph_is_tileable`).
    Distance is the canonical exclusion: an iterative wrap propagation
    cannot roll on a padded plane, so partitions containing it fall back
    to the dense fused path."""

    def ok(node, top: bool) -> bool:
        kind = node.node_type.kind
        if top and node.node_id in preset_nodes:
            return True
        if allow_graph and kind == K.GRAPH:
            return all(ok(m, False) for m in node.node_type.payload.nodes)
        if not top and kind == K.EMBED:
            return False
        return kind in BUCKETABLE_KINDS

    return all(ok(n, True) for n in graph.nodes)


def split_segments(graph, preset_nodes=frozenset()):
    """Topological segmentation of a FLAT graph into maximal
    same-bucketability layers (VERDICT r4 #2 — partition splitting at
    unbucketable boundaries).

    Returns `[(is_bucketable, [node_ids]), ...]` in evaluation order. Each
    node's layer index k = max over parents of (k(parent) + 1 if the
    bucketability color changes on that edge else 0); nodes group by
    (k, color). Since k is non-decreasing along every edge and two
    same-k nodes of different color can share no edge (an edge between
    different colors increments k), ordering segments by k is a valid
    schedule, and a chain independent of any unbucketable node stays in
    one k=0 segment — the segment count grows only with unbucketable
    NESTING depth, not graph size. Preset (clean-boundary) nodes belong
    to no segment; their planes arrive via bindings."""
    from .compiler import _topo_order

    parents: dict = {}
    for e in graph.edges:
        parents.setdefault(e.input_id, set()).add(e.output_id)
    color = {
        n.node_id: n.node_type.kind in BUCKETABLE_KINDS
        for n in graph.nodes
        if n.node_id not in preset_nodes
    }
    k: dict = {}
    for nid in _topo_order(graph):
        if nid not in color:
            continue
        best = 0
        for p in parents.get(nid, ()):
            if p in color:
                best = max(best, k[p] + (1 if color[p] != color[nid] else 0))
        k[nid] = best
    groups: dict = {}
    for nid, kk in k.items():
        groups.setdefault((kk, color[nid]), []).append(nid)
    return [
        (c, sorted(groups[(kk, c)], key=int))
        for kk, c in sorted(groups, key=lambda t: (t[0], not t[1]))
    ]


def bucket_of(n: int, bucket: int) -> int:
    """Pad target for a true extent: tiny sizes stay exact (defaults and
    Value planes), sub-bucket sizes round to powers of two, larger sizes to
    the next `bucket` multiple."""
    n = int(n)
    if n <= 16:
        return n
    if n < bucket:
        p = 16
        while p < n:
            p *= 2
        return p
    return -(-n // bucket) * bucket


def _bucket_lo(p: int, bucket: int) -> int:
    """Smallest true extent mapping to pad target `p` (for tap bounds).

    The first `bucket` multiple is still reached from the pow-2 ladder
    (extents bucket/2+1 … bucket all pad to `bucket`), so it uses the
    ladder's lower bound — `p - bucket + 1` would be 1 and inflate the tap
    bound ~60× for downscales into the 129–256 px range."""
    if p <= 16:
        return p
    if p <= bucket:
        return p // 2 + 1
    return p - bucket + 1


def size_normalized_fingerprint(graph, extra: str = "") -> str:
    """Structure hash with SpecificSize payloads normalized out (on top of
    the compiler's Value normalization): two graphs differing only in
    dragged sizes share one bucketed evaluator — the size itself rides in
    the marshalled arguments."""
    import hashlib
    import json

    from .compiler import _normalize_values

    def normalize_sizes(gj):
        out = {"nodes": [], "edges": gj["edges"]}
        for node in gj["nodes"]:
            rp = node.get("resize_policy")
            if isinstance(rp, dict) and "SpecificSize" in rp:
                node = dict(node, resize_policy={"SpecificSize": {"width": 0, "height": 0}})
            nt = node.get("node_type")
            if isinstance(nt, dict) and "Noise" in nt:
                # a Noise node's intrinsic size rides in (padded) arguments
                # here, exactly like a dragged SpecificSize
                node = dict(node, node_type={"Noise": dict(nt["Noise"], width=0, height=0)})
            if isinstance(nt, dict) and "Pattern" in nt:
                # same: the size rides in padded index-vector arguments
                node = dict(node, node_type={"Pattern": dict(nt["Pattern"], width=0, height=0)})
            if isinstance(nt, dict) and "Voronoi" in nt:
                # same: the size rides in padded index-vector arguments
                node = dict(node, node_type={"Voronoi": dict(nt["Voronoi"], width=0, height=0)})
            out["nodes"].append(node)
        return out

    blob = json.dumps(
        normalize_sizes(_normalize_values(graph.to_json())), sort_keys=True
    ) + extra
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def _pad1(a: np.ndarray, target: int) -> np.ndarray:
    a = np.asarray(a, dtype=np.int32)
    if len(a) >= target:
        return a[:target]
    fill = a[-1] if len(a) else 0
    return np.concatenate([a, np.full(target - len(a), fill, np.int32)])


class BucketedGraph:
    """Compile-once-per-bucket interactive evaluator for a flat node graph.

    Usage: build, then per size edit mutate the graph's node payloads
    (e.g. a SpecificSize resize policy) and call — the call marshals fresh
    index/weight arguments host-side (~ms) and reuses the bucket's compiled
    executable. `traces` counts actual (re)traces for tests/telemetry.

    Returned planes are READ-ONLY and may be shared: aliased targets
    (SeparateRgba outputs, gray→rgba expansion, pass-through Outputs)
    return views of ONE deduplicated array — the reference's Arc-shared
    channel planes (`separate_rgba.rs:38-68`). Mutating one in place
    mutates every alias; copy first if you must write.
    """

    def __init__(self, node_graph, targets=None, bucket: int = DEFAULT_BUCKET,
                 preset=None, device_out: bool = False, bindings=None,
                 mesh=None, padded_preset=frozenset()):
        import jax

        from . import tiled
        from .compiler import _topo_order
        from .node import NodeTypeKind as _K
        from .ops import image_io

        # preset: {(NodeId, SlotId): n_planes} — clean-boundary nodes whose
        # planes arrive via `preset_<n>_<s>` bindings (engine integration,
        # mirroring the fused/tiled preset convention)
        self.preset = dict(preset or {})
        self._preset_nodes = {nid for nid, _ in self.preset}
        # padded_preset ⊆ preset nodes: inter-SEGMENT boundaries whose
        # planes arrive PADDED to this evaluator's bucket targets (the
        # engine's segmented dispatch — see engine._eval_bucketed_segments).
        # Their argument shapes are then bucket-stable across a size drag
        # (one trace per bucket crossed), unlike true-size preset planes
        # whose every distinct size would mint a fresh trace. Consumers are
        # untouched: same-size edges pass through positionally (both frames
        # padded), resample/gather edges index only true rows, and the tap
        # bound below uses the bucket extent like any computed producer.
        self._padded_presets = frozenset(NodeId(int(p)) for p in padded_preset)
        #: True → __call__ returns device arrays (lazy device slices);
        #: False → host numpy
        self.device_out = device_out
        #: flat (node_id, slot) → original Graph-node (node_id, slot), for
        #: result keys when nested Graph nodes were auto-flattened
        self._remap_back: dict = {}

        #: the pre-flatten graph when nested Graph nodes were inlined: edits
        #: (set_size on the Graph node) target it, and __call__ re-flattens
        #: so the baked pass-through policies track the live payloads
        self._orig_graph = None
        if any(
            n.node_type.kind == _K.GRAPH and n.node_id not in self._preset_nodes
            for n in node_graph.nodes
        ):
            # nested Graph nodes: inline-flatten with the tiled flattener
            # (its size inference needs leaf shapes — decode images here
            # when the caller didn't hand bindings in)
            pre = dict(bindings or {})
            if bindings is None:
                for node in node_graph.nodes:
                    if node.node_type.kind == _K.IMAGE:
                        try:
                            si = image_io.read_slot_image(node.node_type.payload)
                        except TexProError:
                            si = image_io.magenta_placeholder()
                        pre[f"image_{int(node.node_id)}"] = tuple(
                            p.host_data() for p in si.planes
                        )
            flat = tiled.flatten_graph_nodes(node_graph, pre, self.preset)
            if flat is None:
                raise TexProError(
                    ErrorKind.INVALID_NODE_TYPE,
                    "graph cannot be flattened for bucketed evaluation "
                    "(inner Embed node or unbound inner Input)",
                )
            self._orig_graph = node_graph
            node_graph, self._remap_back, extra = flat
            pre.update(extra)
            bindings = pre
            if targets is not None:
                # caller targets naming a Graph node's output slots map to
                # the flattened stand-in nodes
                fwd = {orig: flat_key for flat_key, orig in self._remap_back.items()}
                targets = [
                    fwd.get((NodeId(n), SlotId(s)), (NodeId(n), SlotId(s)))
                    for n, s in targets
                ]

        for node in node_graph.nodes:
            if (
                node.node_type.kind not in BUCKETABLE_KINDS
                and node.node_id not in self._preset_nodes
            ):
                raise TexProError(
                    ErrorKind.INVALID_NODE_TYPE,
                    f"not bucketable: {node.node_type!r}",
                )
        self.graph = node_graph
        self.bucket = int(bucket)
        self._topo = _topo_order(node_graph)
        self.traces = 0
        # mesh composition (DESIGN.md §6): computed planes carry a row-axis
        # sharding constraint so GSPMD partitions the bucketed program too —
        # pad targets ≥ the bucket are 256-multiples and divide any practical
        # mesh row axis. Gather operands (resample taps, wrap stencils) are
        # all-gathered by GSPMD where indices cross shards; elementwise
        # chains stay sharded. Bit parity vs single-device is enforced by
        # tests/test_mesh_engine.py.
        self.mesh = mesh
        self._mesh_axis = mesh.axis_names[0] if mesh is not None else None

        # leaf bindings, uploaded ONCE as device-resident jnp arrays (numpy
        # here would re-upload per call; re-bind via bind_*). An explicit
        # `bindings` dict (engine integration) supersedes the image decode;
        # the auto-flatten branch above hands host planes in, so normalize
        # every plane tuple/list here — INCLUDING the f32 upcast the
        # CLAUDE.md in-flight contract requires (the bucketed twins call
        # `_h2n_core`/the blur tap loop directly, below the eager kernels'
        # entry upcasts, so a bf16 plane binding would otherwise compute
        # half-precision math and return bf16 planes).
        if bindings is not None:
            self._bindings = {
                k: self._norm_planes(v) for k, v in bindings.items()
            }
        else:
            self._bindings = {}
            for node in node_graph.nodes:
                if node.node_type.kind == _K.IMAGE:
                    try:
                        si = image_io.read_slot_image(node.node_type.payload)
                    except TexProError:
                        si = image_io.magenta_placeholder()
                    self._bindings[f"image_{int(node.node_id)}"] = self._norm_planes(
                        tuple(p.host_data() for p in si.planes)
                    )

        if targets is None:
            with_children = {e.output_id for e in node_graph.edges}
            targets = [
                (n.node_id, SlotId(0))
                for n in node_graph.nodes
                if n.node_id not in with_children
            ]
        self.targets = [(NodeId(n), SlotId(s)) for n, s in targets]

        # Cross-target plane aliasing (reference: Arc-shared channel planes,
        # `separate_rgba.rs:38-68`): the traced fn returns UNIQUE planes plus
        # a trace-recorded layout, exactly like `CompiledGraph.call_with_layout`
        # — aliasing depends on shapes (same-size edges alias, resampled ones
        # copy), so layouts key on the arg-shape signature. One shared mutable
        # container: `with_state` handles are shallow copies, and `_fn` is
        # bound to THIS instance, so both must see the same state.
        from .compiler import _PendingLayout

        self._layout_state = {
            "layouts": {},
            "pending": _PendingLayout(),
            # node table a (re)trace reads — published under the trace lock
            # by _call_with_layout so retraces triggered by a with_state
            # handle bake THAT handle's payloads, not the base instance's
            "trace_nodes": {n.node_id: n for n in node_graph.nodes},
        }
        self._trace_lock = __import__("threading").Lock()

        # structural metadata (plane counts + input lists) from one
        # inference pass — size-independent as long as topology/bindings
        # plane counts stay fixed
        infos0 = tiled.infer_sizes(node_graph, self._tiled_bindings(), self.preset)
        self._counts = {nid: dict(info.out_planes) for nid, info in infos0.items()}
        self._inputs = {nid: list(info.inputs) for nid, info in infos0.items()}

        # payload_fp (static): trace-BAKED payloads (Mix type, Blur tap
        # weights) ride in the executable, not in arguments — a payload
        # edit that keeps every argument shape (σ=0.9→1.0 is still 7 taps)
        # must still mint a fresh trace, or the old weights serve silently
        self._jit = jax.jit(self._fn, static_argnums=(1,))

    def with_state(self, graph, bindings: dict) -> "BucketedGraph":
        """A shallow handle sharing this evaluator's compiled executables
        (`self._jit`) and structural metadata but reading node payloads and
        leaf bindings from fresh state — the engine hands these out per
        dispatch so a cached evaluator serves edited graphs (structure must
        match: same size-normalized fingerprint — which covers trace-baked
        payloads like Mix type and Blur taps, so shared executables stay
        valid; a direct caller editing those payloads retraces via the
        payload fingerprint in the program key). `graph` must be FLAT
        (nested Graph nodes already inlined): the handle's graph is
        authoritative, so it does not inherit the base evaluator's
        auto-re-flatten of its construction-time original."""
        import copy

        handle = copy.copy(self)
        handle.graph = graph
        handle._orig_graph = None  # the handle's graph IS the fresh state
        handle._bindings = {k: self._norm_planes(v) for k, v in bindings.items()}
        return handle

    @staticmethod
    def _norm_planes(v):
        """Upload a plane tuple/list at f32 (f32-in-flight contract; no-op
        for planes already f32 on device). Non-plane values pass through."""
        import jax.numpy as jnp

        if isinstance(v, (tuple, list)):
            # jnp.asarray is a no-op (same buffer) for device-resident f32
            # planes, an upload for host arrays, and an f32 upcast for
            # anything half-precision
            return tuple(jnp.asarray(p, jnp.float32) for p in v)
        return v

    # --- bindings ---
    def _tiled_bindings(self) -> dict:
        from .compiler import collect_value_bindings

        b = dict(self._bindings)
        b.update(collect_value_bindings(self.graph))
        return b

    def bind_input(self, node_id, planes) -> None:
        import jax.numpy as jnp

        self._bindings[f"input_{int(node_id)}"] = tuple(
            jnp.asarray(np.asarray(p, np.float32)) for p in planes
        )

    def bind_embed(self, embedded_slot_data_id, planes) -> None:
        import jax.numpy as jnp

        self._bindings[f"embed_{int(embedded_slot_data_id)}"] = tuple(
            jnp.asarray(np.asarray(p, np.float32)) for p in planes
        )

    def set_size(self, node_id, size: Size) -> None:
        """Interactive size edit: point `node_id`'s resize policy at `size`
        (`NodeGraph.node` returns clones, so a convenience mutator is the
        honest API here). With auto-flattened nested Graph nodes, edits
        target the ORIGINAL graph and the next call re-flattens."""
        from .node import ResizePolicy

        target = self._orig_graph if self._orig_graph is not None else self.graph
        node = target._node_with_id_mut(NodeId(int(node_id)))
        if node is None:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.resize_policy = ResizePolicy.SpecificSize(size)

    # --- per-call marshalling (host) ---
    def _payload_fp(self) -> tuple:
        """Hashable fingerprint of trace-baked payloads (static jit arg):
        Mix type and Blur σ are baked into the executable; everything else
        (sizes, Value/Levels params, tap indices/weights) rides in args."""
        parts = []
        for n in self.graph.nodes:
            k = n.node_type.kind
            if k == K.MIX:
                parts.append((int(n.node_id), "mix", n.node_type.payload))
            elif k == K.BLUR:
                parts.append(
                    (int(n.node_id), "blur", round(float(n.node_type.payload), 6))
                )
            elif k == K.AMBIENT_OCCLUSION:
                # radius bakes the per-scale tap WEIGHTS (trace constants);
                # same-shape index args could otherwise reuse a stale
                # executable after a radius edit within one tap-count class
                parts.append(
                    (int(n.node_id), "ao",
                     round(float(n.node_type.payload[1]), 6))
                )
        return tuple(parts)

    def _marshal(self, infos) -> dict:
        B = self.bucket
        args: dict = {}
        # one pass over the node list (NodeGraph.node() is a linear scan +
        # payload clone PER CALL — O(N^2) scans and N clones per drag tick)
        nodes = {n.node_id: n for n in self.graph.nodes}
        for node_id in self._topo:
            node = nodes[node_id]
            kind = node.node_type.kind
            nid = int(node_id)
            info = infos[node_id]

            if node_id in self._preset_nodes:
                for (pn, slot), count in self.preset.items():
                    if pn != node_id:
                        continue
                    planes = self._bindings.get(f"preset_{nid}_{int(slot)}")
                    if planes is None:
                        raise TexProError(
                            ErrorKind.INVALID_BUFFER_COUNT,
                            f"no binding preset_{nid}_{int(slot)}",
                        )
                    for p in range(count):
                        args[f"pleaf_{nid}_{int(slot)}_{p}"] = planes[p]
                continue

            if kind == K.VALUE:
                args[f"value_{nid}"] = np.float32(node.node_type.payload)
                continue
            if kind == K.NOISE:
                from .ops.noise import noise_bindings

                nb = noise_bindings(node.node_type.payload)
                th, tw = info.out_size.height, info.out_size.width
                # padded index vectors: pad rows/cols repeat the last true
                # coordinate (computed redundantly, cropped at commit)
                args[f"nzr_{nid}"] = _pad1(nb["rows"], bucket_of(th, B))
                args[f"nzc_{nid}"] = _pad1(nb["cols"], bucket_of(tw, B))
                args[f"nzs_{nid}"] = nb["seed"]
                args[f"nzp_{nid}"] = nb["persistence"]
                args[f"nzfx_{nid}"] = nb["fx"]
                args[f"nzfy_{nid}"] = nb["fy"]
                args[f"nzpd_{nid}"] = nb["periods"]
                continue
            if kind == K.PATTERN:
                from .ops.pattern import pattern_bindings

                pb = pattern_bindings(node.node_type.payload)
                th, tw = info.out_size.height, info.out_size.width
                args[f"ptr_{nid}"] = _pad1(pb["rows"], bucket_of(th, B))
                args[f"ptc_{nid}"] = _pad1(pb["cols"], bucket_of(tw, B))
                for field in ("fx", "fy", "px", "py", "mortar", "bevel", "seed"):
                    args[f"pt{field}_{nid}"] = pb[field]
                continue
            if kind == K.VORONOI:
                from .ops.voronoi import voronoi_bindings

                vb = voronoi_bindings(node.node_type.payload)
                th, tw = info.out_size.height, info.out_size.width
                args[f"vor_{nid}"] = _pad1(vb["rows"], bucket_of(th, B))
                args[f"voc_{nid}"] = _pad1(vb["cols"], bucket_of(tw, B))
                for field in ("fx", "fy", "px", "py", "jitter", "seed"):
                    args[f"vo{field}_{nid}"] = vb[field]
                continue
            if kind == K.RAMP:
                from .ops.ramp import ramp_bindings

                rb = ramp_bindings(node.node_type.payload)
                th, tw = info.out_size.height, info.out_size.width
                args[f"rpr_{nid}"] = _pad1(rb["rows"], bucket_of(th, B))
                args[f"rpc_{nid}"] = _pad1(rb["cols"], bucket_of(tw, B))
                args[f"rpiw_{nid}"] = rb["iw"]
                args[f"rpih_{nid}"] = rb["ih"]
                args[f"rpk_{nid}"] = rb["k"]
                continue
            if kind in _LEAF_KINDS:
                if kind == K.IMAGE:
                    key = f"image_{nid}"
                elif kind == K.EMBED:
                    key = f"embed_{int(node.node_type.payload)}"
                else:
                    key = f"input_{nid}"
                if kind == K.INPUT_RGBA and key not in self._bindings:
                    key = "input_rgba_first"
                planes = self._bindings.get(key)
                if planes is None:
                    raise TexProError(
                        ErrorKind.INVALID_BUFFER_COUNT, f"no binding {key}"
                    )
                for p, plane in enumerate(planes):
                    args[f"leaf_{nid}_{p}"] = plane
                continue

            if info.working is None or not self._inputs[node_id]:
                continue  # no inputs: the emit uses 1×1 defaults, no args
            th, tw = info.working.height, info.working.width
            ph_, pw_ = bucket_of(th, B), bucket_of(tw, B)

            for slot, pid, pslot in self._inputs[node_id]:
                parent = infos[pid]
                pk = parent.node.node_type.kind
                psz = parent.slot_size(pslot)
                base = f"{nid}_{int(slot)}"
                if (psz.height, psz.width) != (th, tw):
                    # argumentized two-pass resample (resample_plane twin)
                    filt = node.resize_filter
                    for axis, in_len, out_len, out_pad in (
                        ("r", psz.height, th, ph_),
                        ("c", psz.width, tw, pw_),
                    ):
                        lefts, weights = resample_weights(in_len, out_len, filt)
                        taps = weights.shape[1]
                        t_bound = self._tap_bound(pid, pk, in_len, out_pad, filt)
                        t_bound = max(t_bound, taps)
                        idx = np.clip(
                            lefts[:, None] + np.arange(taps)[None, :],
                            0,
                            in_len - 1,
                        ).astype(np.int32)
                        idxp = np.zeros((out_pad, t_bound), np.int32)
                        wp = np.zeros((out_pad, t_bound), np.float32)
                        idxp[:out_len, :taps] = idx
                        wp[:out_len, :taps] = weights
                        args[f"{axis}i_{base}"] = idxp
                        args[f"{axis}w_{base}"] = wp
                else:
                    # same size: pad-gather only if the parent's plane shape
                    # differs from this node's padded shape
                    psh = self._plane_shape(pid, pk, psz, B)
                    if psh != (ph_, pw_):
                        args[f"g_{base}"] = _pad1(np.arange(th), ph_)
                        args[f"c_{base}"] = _pad1(np.arange(tw), pw_)

            if kind == K.HEIGHT_TO_NORMAL:
                args[f"u_{nid}"] = _pad1((np.arange(th) - 1) % th, ph_)
                args[f"hl_{nid}"] = _pad1((np.arange(tw) - 1) % tw, pw_)
                args[f"pdx_{nid}"] = np.float32(1.0) / np.float32(tw)
                args[f"pdy_{nid}"] = np.float32(1.0) / np.float32(th)
            elif kind == K.CURVATURE:
                # pre-gathered wrap neighbors (a roll on a padded plane
                # would wrap into the pad); pad entries repeat the last
                # true coordinate — computed redundantly, cropped at commit
                args[f"cvu_{nid}"] = _pad1((np.arange(th) - 1) % th, ph_)
                args[f"cvd_{nid}"] = _pad1((np.arange(th) + 1) % th, ph_)
                args[f"cvl_{nid}"] = _pad1((np.arange(tw) - 1) % tw, pw_)
                args[f"cvr_{nid}"] = _pad1((np.arange(tw) + 1) % tw, pw_)
                args[f"cv_{nid}"] = np.float32(node.node_type.payload)
            elif kind == K.BLUR:
                from .ops.blur import gaussian_taps

                taps = gaussian_taps(round(float(node.node_type.payload), 6))
                r = (len(taps) - 1) // 2
                args[f"bv_{nid}"] = np.stack(
                    [_pad1((np.arange(th) + t - r) % th, ph_) for t in range(len(taps))]
                )
                args[f"bh_{nid}"] = np.stack(
                    [_pad1((np.arange(tw) + t - r) % tw, pw_) for t in range(len(taps))]
                )
            elif kind == K.AMBIENT_OCCLUSION:
                from .ops.ambient_occlusion import ao_taps

                for i, taps in enumerate(ao_taps(node.node_type.payload[1])):
                    r = (len(taps) - 1) // 2
                    args[f"aobv{i}_{nid}"] = np.stack(
                        [_pad1((np.arange(th) + t - r) % th, ph_)
                         for t in range(len(taps))]
                    )
                    args[f"aobh{i}_{nid}"] = np.stack(
                        [_pad1((np.arange(tw) + t - r) % tw, pw_)
                         for t in range(len(taps))]
                    )
                args[f"ao_{nid}"] = np.float32(node.node_type.payload[0])
            elif kind == K.LEVELS:
                args[f"lv_{nid}"] = np.asarray(node.node_type.payload, np.float32)
            elif kind == K.HSV:
                from .ops.hsv import hsv_bindings

                args[f"hsv_{nid}"] = hsv_bindings(node.node_type.payload)
            elif kind == K.GRADIENT_MAP:
                from .ops.gradient import gradient_bindings

                gb = gradient_bindings(node.node_type.payload)
                args[f"gdp_{nid}"] = gb["pos"]
                args[f"gdc_{nid}"] = gb["colors"]
            elif kind == K.TRANSFORM:
                from .ops.transform import transform_bindings

                xb = transform_bindings(node.node_type.payload)
                args[f"xfcs_{nid}"] = xb["cs"]
                args[f"xfis_{nid}"] = xb["inv_s"]
                args[f"xfof_{nid}"] = xb["off"]
                # padded GLOBAL output index vectors + LOGICAL wrap extents
                # as runtime scalars: size drags within a bucket reuse the
                # program; wrapped gathers never touch pad texels
                args[f"xfr_{nid}"] = _pad1(np.arange(th), ph_)
                args[f"xfc_{nid}"] = _pad1(np.arange(tw), pw_)
                args[f"xfh_{nid}"] = np.int32(th)
                args[f"xfw_{nid}"] = np.int32(tw)
            elif kind == K.WARP:
                from .ops.warp import warp_bindings

                wb = warp_bindings(node.node_type.payload)
                args[f"wpk_{nid}"] = wb["k"]
                # same padded-index/runtime-extent scheme as Transform; the
                # strength map is used POSITIONALLY (padded plane, aligned
                # grid), so pad texels only ever produce pad outputs
                args[f"wpr_{nid}"] = _pad1(np.arange(th), ph_)
                args[f"wpc_{nid}"] = _pad1(np.arange(tw), pw_)
                args[f"wph_{nid}"] = np.int32(th)
                args[f"wpw_{nid}"] = np.int32(tw)
        return args

    def _plane_shape(self, pid, kind, size: Size, B: int) -> tuple:
        """In-trace plane shape of a producer: leaves and preset boundary
        planes stay at true shape, computed nodes are padded — and padded
        segment-boundary presets (engine segmented dispatch) arrive at
        bucket targets like computed nodes."""
        if pid in self._padded_presets:
            return (bucket_of(size.height, B), bucket_of(size.width, B))
        if kind in _LEAF_KINDS or kind == K.VALUE or pid in self._preset_nodes:
            return (size.height, size.width)
        return (bucket_of(size.height, B), bucket_of(size.width, B))

    def _tap_bound(self, pid, pk, in_len, out_pad, filt) -> int:
        """Bucket-stable tap-count bound: worst ratio over the bucket =
        largest in extent (the parent's pad target; leaves/preset are
        static) over the smallest out extent mapping to `out_pad`."""
        B = self.bucket
        if pid in self._padded_presets:
            # padded segment-boundary planes: bound like a computed
            # producer so the tap arg width is bucket-stable across drags
            in_hi = bucket_of(in_len, B)
        elif pk in _LEAF_KINDS or pk == K.VALUE or pid in self._preset_nodes:
            in_hi = in_len
        else:
            in_hi = bucket_of(in_len, B)
        out_lo = _bucket_lo(out_pad, B)
        return resample_weights(in_hi, max(1, out_lo), filt)[1].shape[1]

    # --- the traced evaluation (shapes come ONLY from args) ---
    def _fn(self, args: dict, payload_fp: tuple = ()) -> dict:
        # payload_fp is static: its only job is keying jax.jit's trace
        # cache so baked payloads (Mix type, Blur taps) can't go stale
        import jax.numpy as jnp

        from .compiler import ImgVal, _as_type, _from_value, _ones, _ones_like, _zeros
        from .ops.resize import _apply_axis0_indexed

        if self.mesh is not None:
            from jax.lax import with_sharding_constraint
            from jax.sharding import NamedSharding, PartitionSpec as P

            _row_sharding = NamedSharding(self.mesh, P(self._mesh_axis, None))
            _n_dev = self.mesh.devices.shape[0]

            def shard(planes):
                # constrain only fresh compute outputs — constraining an
                # aliasing op would mint a new traced value and break the
                # unique-plane layout dedup. Tiny planes stay replicated.
                return [
                    with_sharding_constraint(p, _row_sharding)
                    if p.ndim == 2 and p.shape[0] >= _n_dev
                    else p
                    for p in planes
                ]
        else:
            def shard(planes):
                return list(planes)

        self.traces += 1
        env: dict = {}
        # the CALLING instance's node table (with_state handles publish
        # theirs under the trace lock; `self` here is always the base
        # instance the jit was built on)
        trace_nodes = self._layout_state["trace_nodes"]

        for node_id in self._topo:
            node = trace_nodes[node_id]
            kind = node.node_type.kind
            nid = int(node_id)

            if node_id in self._preset_nodes:
                for (pn, slot), count in self.preset.items():
                    if pn == node_id:
                        env[(node_id, slot)] = ImgVal(
                            [
                                args[f"pleaf_{nid}_{int(slot)}_{p}"]
                                for p in range(count)
                            ]
                        )
                continue

            if kind == K.VALUE:
                env[(node_id, SlotId(0))] = ImgVal(
                    [jnp.reshape(jnp.asarray(args[f"value_{nid}"], jnp.float32), (1, 1))]
                )
                continue
            if kind == K.NOISE:
                from .ops.noise import noise_plane

                plane = noise_plane(
                    args[f"nzr_{nid}"], args[f"nzc_{nid}"],
                    args[f"nzs_{nid}"], args[f"nzp_{nid}"],
                    args[f"nzfx_{nid}"], args[f"nzfy_{nid}"],
                    args[f"nzpd_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard([plane]))
                continue
            if kind == K.PATTERN:
                from .ops.pattern import pattern_planes

                mask, cells = pattern_planes(
                    node.node_type.payload[2],
                    args[f"ptr_{nid}"], args[f"ptc_{nid}"],
                    args[f"ptfx_{nid}"], args[f"ptfy_{nid}"],
                    args[f"ptpx_{nid}"], args[f"ptpy_{nid}"],
                    args[f"ptmortar_{nid}"], args[f"ptbevel_{nid}"],
                    args[f"ptseed_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard([mask]))
                env[(node_id, SlotId(1))] = ImgVal(shard([cells]))
                continue
            if kind == K.VORONOI:
                from .ops.voronoi import voronoi_planes

                distance, borders, vcells = voronoi_planes(
                    args[f"vor_{nid}"], args[f"voc_{nid}"],
                    args[f"vofx_{nid}"], args[f"vofy_{nid}"],
                    args[f"vopx_{nid}"], args[f"vopy_{nid}"],
                    args[f"vojitter_{nid}"], args[f"voseed_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard([distance]))
                env[(node_id, SlotId(1))] = ImgVal(shard([borders]))
                env[(node_id, SlotId(2))] = ImgVal(shard([vcells]))
                continue
            if kind == K.RAMP:
                from .ops.ramp import ramp_plane

                plane = ramp_plane(
                    node.node_type.payload[2],
                    args[f"rpr_{nid}"], args[f"rpc_{nid}"],
                    args[f"rpiw_{nid}"], args[f"rpih_{nid}"],
                    args[f"rpk_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard([plane]))
                continue
            if kind in _LEAF_KINDS:
                count = self._counts[node_id][SlotId(0)]
                env[(node_id, SlotId(0))] = ImgVal(
                    [args[f"leaf_{nid}_{p}"] for p in range(count)]
                )
                continue

            def edge_val(slot, pid, pslot):
                planes = env[(pid, pslot)].planes
                base = f"{nid}_{int(slot)}"
                if f"ri_{base}" in args:
                    vert = [
                        _apply_axis0_indexed(p, args[f"ri_{base}"], args[f"rw_{base}"])
                        for p in planes
                    ]
                    return ImgVal(
                        [
                            _apply_axis0_indexed(
                                v.T, args[f"ci_{base}"], args[f"cw_{base}"]
                            ).T
                            for v in vert
                        ]
                    )
                if f"g_{base}" in args:
                    g, c = args[f"g_{base}"], args[f"c_{base}"]
                    return ImgVal([p[g][:, c] for p in planes])
                return ImgVal(list(planes))

            by_slot = {
                slot: edge_val(slot, pid, pslot)
                for slot, pid, pslot in self._inputs[node_id]
            }

            if kind in (K.OUTPUT_GRAY, K.OUTPUT_RGBA):
                if by_slot:
                    env[(node_id, SlotId(0))] = by_slot[min(by_slot)]
                elif kind == K.OUTPUT_RGBA:
                    z = _zeros((1, 1))
                    env[(node_id, SlotId(0))] = ImgVal(
                        [z, z, z, _ones((1, 1))]
                    )
                else:
                    env[(node_id, SlotId(0))] = ImgVal([_zeros((1, 1))])
                continue

            if kind == K.MIX:
                from .ops.mix import _binary

                left, right = by_slot.get(SlotId(0)), by_slot.get(SlotId(1))
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
                    env[(node_id, SlotId(0))] = ImgVal([_zeros((1, 1))])
                    continue
                op = _binary(node.node_type.payload)
                if left.is_rgba:
                    planes = [op(left.planes[i], right.planes[i]) for i in range(3)]
                    planes.append(_ones_like(planes[0]))
                else:
                    planes = [op(left.planes[0], right.planes[0])]
                env[(node_id, SlotId(0))] = ImgVal(shard(planes))
                continue

            if kind == K.HEIGHT_TO_NORMAL:
                from .ops.height_to_normal import _h2n_core

                h = by_slot[SlotId(0)].planes[0]
                up = h[args[f"u_{nid}"]]
                left = h[:, args[f"hl_{nid}"]]
                outs = _h2n_core(
                    h, up, 0, 0,
                    left=left, pdx=args[f"pdx_{nid}"], pdy=args[f"pdy_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard(outs))
                continue

            if kind == K.CURVATURE:
                from .ops.curvature import curvature_plane

                h = by_slot[SlotId(0)].planes[0]
                out = curvature_plane(
                    h, args[f"cv_{nid}"],
                    up=h[args[f"cvu_{nid}"]], down=h[args[f"cvd_{nid}"]],
                    left=h[:, args[f"cvl_{nid}"]], right=h[:, args[f"cvr_{nid}"]],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard([out]))
                continue

            if kind == K.BLUR:
                from .ops.blur import gaussian_taps
                from .ops.exact_math import nc_mul

                taps = gaussian_taps(round(float(node.node_type.payload), 6))
                bv, bh = args[f"bv_{nid}"], args[f"bh_{nid}"]
                planes = []
                for p in by_slot[SlotId(0)].planes:
                    acc = jnp.zeros_like(p)
                    for t, w in enumerate(taps):
                        acc = acc + nc_mul(p[bv[t]], jnp.float32(w))
                    out = jnp.zeros_like(acc)
                    for t, w in enumerate(taps):
                        out = out + nc_mul(acc[:, bh[t]], jnp.float32(w))
                    planes.append(out)
                env[(node_id, SlotId(0))] = ImgVal(shard(planes))
                continue

            if kind == K.AMBIENT_OCCLUSION:
                from .ops.ambient_occlusion import ao_combine, ao_taps
                from .ops.exact_math import nc_mul

                p = by_slot[SlotId(0)].planes[0]
                blurred = []
                # per scale: Blur's pre-gathered wrap formulation (pad
                # entries repeat the last true coordinate — pad region is
                # computed redundantly and cropped at commit)
                for i, taps in enumerate(ao_taps(node.node_type.payload[1])):
                    bv = args[f"aobv{i}_{nid}"]
                    bh = args[f"aobh{i}_{nid}"]
                    acc = jnp.zeros_like(p)
                    for t, w in enumerate(taps):
                        acc = acc + nc_mul(p[bv[t]], jnp.float32(w))
                    out = jnp.zeros_like(acc)
                    for t, w in enumerate(taps):
                        out = out + nc_mul(acc[:, bh[t]], jnp.float32(w))
                    blurred.append(out)
                out = ao_combine(p, blurred, args[f"ao_{nid}"])
                env[(node_id, SlotId(0))] = ImgVal(shard([out]))
                continue

            if kind == K.LEVELS:
                from .ops.levels import levels_plane

                params = args[f"lv_{nid}"]
                env[(node_id, SlotId(0))] = ImgVal(
                    shard([levels_plane(p, params) for p in by_slot[SlotId(0)].planes])
                )
                continue

            if kind == K.HSV:
                from .ops.hsv import hsv_planes

                env[(node_id, SlotId(0))] = ImgVal(
                    shard(hsv_planes(by_slot[SlotId(0)].planes, args[f"hsv_{nid}"]))
                )
                continue

            if kind == K.GRADIENT_MAP:
                from .ops.gradient import gradient_planes

                outs = gradient_planes(
                    by_slot[SlotId(0)].planes[0], args[f"gdp_{nid}"], args[f"gdc_{nid}"]
                )
                env[(node_id, SlotId(0))] = ImgVal(shard(list(outs)))
                continue

            if kind == K.TRANSFORM:
                from .ops.transform import transform_planes

                outs = transform_planes(
                    by_slot[SlotId(0)].planes,
                    args[f"xfr_{nid}"], args[f"xfc_{nid}"],
                    args[f"xfcs_{nid}"], args[f"xfis_{nid}"], args[f"xfof_{nid}"],
                    args[f"xfh_{nid}"], args[f"xfw_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard(list(outs)))
                continue

            if kind == K.WARP:
                from .ops.warp import warp_planes

                strength = by_slot.get(SlotId(1))
                if strength is None:
                    # pass-through alias, like the other consumers
                    env[(node_id, SlotId(0))] = by_slot[SlotId(0)]
                    continue
                outs = warp_planes(
                    by_slot[SlotId(0)].planes,
                    strength.planes[0],  # padded, positionally aligned
                    args[f"wpr_{nid}"], args[f"wpc_{nid}"],
                    args[f"wpk_{nid}"],
                    args[f"wph_{nid}"], args[f"wpw_{nid}"],
                )
                env[(node_id, SlotId(0))] = ImgVal(shard(list(outs)))
                continue

            if kind == K.SEPARATE_RGBA:
                inp = by_slot.get(SlotId(0))
                if inp is not None and inp.is_rgba:
                    for i in range(4):
                        env[(node_id, SlotId(i))] = ImgVal([inp.planes[i]])
                else:
                    for i in range(4):
                        env[(node_id, SlotId(i))] = ImgVal([_zeros((1, 1))])
                continue

            if kind == K.COMBINE_RGBA:
                size = by_slot[min(by_slot)].size if by_slot else Size(1, 1)
                shape = (size.height, size.width)
                shared_zero = None

                def color(slot):
                    nonlocal shared_zero
                    img = by_slot.get(SlotId(slot))
                    if img is not None:
                        return img.planes[0]
                    if shared_zero is None:
                        shared_zero = _zeros(shape)
                    return shared_zero

                alpha_img = by_slot.get(SlotId(3))
                alpha = (
                    alpha_img.planes[0]
                    if alpha_img is not None
                    else _ones(shape)
                )
                env[(node_id, SlotId(0))] = ImgVal(
                    [color(0), color(1), color(2), alpha]
                )
                continue

            raise TexProError(  # pragma: no cover — gated in __init__
                ErrorKind.INVALID_NODE_TYPE, f"cannot bucket {node.node_type!r}"
            )

        unique: dict = {}  # id(tracer) → (index, tracer)
        layout: dict = {}
        for tnid, tslot in self.targets:
            idxs = []
            for plane in env[(tnid, tslot)].planes:
                pid = id(plane)
                if pid not in unique:
                    unique[pid] = (len(unique), plane)
                idxs.append(unique[pid][0])
            layout[(tnid, tslot)] = tuple(idxs)
        self._layout_state["pending"].value = layout
        ordered = sorted(unique.values(), key=lambda iv: iv[0])
        return tuple(plane for _, plane in ordered)

    # --- evaluation ---
    def __call__(self, infos=None) -> dict:
        from . import tiled

        if self._orig_graph is not None and infos is None:
            # re-flatten so the stand-in pass-through policies track the
            # original Graph node's live payloads (node ids are derived
            # deterministically, so the flat STRUCTURE — and therefore the
            # jitted executables — are unchanged)
            flat = tiled.flatten_graph_nodes(
                self._orig_graph, self._bindings, self.preset
            )
            if flat is None:  # pragma: no cover — structure validated at init
                raise TexProError(ErrorKind.INVALID_NODE_TYPE, "re-flatten failed")
            self.graph, self._remap_back, extra = flat
            # merge: scalars (inner Value payloads) always refresh; plane
            # tuples keep the device-resident upload from construction
            # (the flattener itself skips re-DECODING inner images whose
            # binding key it was handed — re-decoding or re-uploading per
            # drag tick would defeat the point)
            for k, v in extra.items():
                if isinstance(v, tuple):
                    if k not in self._bindings:
                        self._bindings[k] = self._norm_planes(v)
                else:
                    self._bindings[k] = v

        if infos is None:
            infos = tiled.infer_sizes(self.graph, self._tiled_bindings(), self.preset)
        args = self._marshal(infos)
        out, layout = self._call_with_layout(args)
        # planes are deduplicated: aliased targets (Separate outputs, gray→
        # rgba expansion, pass-through Outputs) share ONE sliced array — the
        # engine wraps each unique array in one PlaneBuffer, preserving the
        # reference's Arc-shared-plane accounting through the bucketed path.
        # Callers must treat returned planes as read-only (they may be shared).
        uniq = list(out) if self.device_out else [np.asarray(p) for p in out]
        slices: dict = {}  # (unique index, h, w) → sliced plane
        results: dict = {}
        for tnid, tslot in self.targets:
            size = infos[tnid].slot_size(tslot)
            # auto-flattened Graph-node outputs key back to the ORIGINAL
            # (graph_node, slot) the caller targeted
            key = self._remap_back.get((tnid, tslot), (tnid, tslot))
            planes = []
            for uidx in layout[(tnid, tslot)]:
                sk = (uidx, size.height, size.width)
                if sk not in slices:
                    slices[sk] = uniq[uidx][: size.height, : size.width]
                planes.append(slices[sk])
            results[key] = planes
        return results

    def _call_with_layout(self, args: dict):
        """Run the jitted program, returning `(unique_planes, layout)` for
        exactly this call's arg shapes + baked payloads (the
        `call_with_layout` protocol)."""
        fp = self._payload_fp()
        sig = (
            fp,
            tuple((k, tuple(getattr(args[k], "shape", ()))) for k in sorted(args)),
        )
        from .compiler import call_with_pending_layout

        state = self._layout_state
        nodes = {n.node_id: n for n in self.graph.nodes}
        return call_with_pending_layout(
            lambda a: self._jit(a, fp), args, sig, self._trace_lock,
            state["layouts"], state["pending"],
            "bucketed program produced no layout for new shapes",
            # published under the lock so a concurrent lock-free hit-path
            # caller can't clobber the table mid-trace
            on_trace=lambda: state.__setitem__("trace_nodes", nodes),
        )
