"""Live graph: per-node clean/dirty state over a `NodeGraph`.

Mirrors `/root/reference/src/live_graph.rs`. The node-state machine
(Clean / Dirty / Requested / Prioritised / Processing / ProcessingDirty,
`live_graph.rs:23-37`), dirty propagation to descendants (`:515-537`), the
`changed` feed for UIs (`:69,156-160`), request/prioritise, and the
edit-cancels-in-flight-work rules (`:488-511,551-594`) are ported 1:1 — this
is host-side control logic steering device execution.

Synchronization: the reference wraps LiveGraph in `Arc<RwLock<_>>` and callers
spin-wait 1 ms for states (`live_graph.rs:164-195`). Here every public method
is guarded by one reentrant lock, `read()`/`write()` context managers group
multi-call sections, and `await_clean_read/write` block on a condition
variable notified by state changes instead of polling.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from enum import Enum
from typing import Optional

from .errors import ErrorKind, TexProError
from .ids import NodeId, SlotId
from .node import Node, Side
from .node_graph import NodeGraph
from .ops.embed import EmbeddedSlotData, EmbeddedSlotDataId
from .priority import PriorityPropagator
from .slot_data import SlotData, Size


class NodeState(Enum):
    CLEAN = "Clean"
    DIRTY = "Dirty"
    REQUESTED = "Requested"
    PRIORITISED = "Prioritised"
    PROCESSING = "Processing"
    PROCESSING_DIRTY = "ProcessingDirty"

    @staticmethod
    def default() -> "NodeState":
        return NodeState.DIRTY


_DIRTYISH = (NodeState.DIRTY, NodeState.REQUESTED, NodeState.PRIORITISED)
_PROCESSINGISH = (NodeState.PROCESSING, NodeState.PROCESSING_DIRTY)


def _journaled(eager: bool = False):
    """Wrap a topology-mutating LiveGraph method as one undo unit (see the
    edit-history block in `__init__`). Standalone calls open their own unit;
    calls inside an open unit (a `write()` transaction, or another mutator)
    lazily capture the enclosing unit's pre-edit snapshot — so read-only
    `write()` blocks (the engine's scheduler/commit scopes) never serialize
    anything. `eager` forces a journal entry even when the topology is
    unchanged at method exit — `node_mut` needs it because the caller
    mutates the returned node AFTER the call returns."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with self._lock:
                if self.history_capacity <= 0:
                    return fn(self, *args, **kwargs)
                if self._txn_depth > 0:
                    if self._txn_pre is None:
                        self._txn_pre = self._history_snapshot()
                    if eager:
                        self._txn_eager = True
                    return fn(self, *args, **kwargs)
                with self._edit_unit(eager=eager, capture=True):
                    return fn(self, *args, **kwargs)

        return wrapper

    return deco


class LiveGraph:
    def __init__(self, buffer_queue):
        self._lock = threading.RLock()
        self._state_cv = threading.Condition(threading.Lock())
        self.node_graph = NodeGraph()
        self.slot_datas: list[SlotData] = []
        self._embedded_slot_datas: list[EmbeddedSlotData] = []
        self._input_slot_datas: list[SlotData] = []
        self._node_state: dict[NodeId, NodeState] = {}
        self._changed: set[NodeId] = set()
        self.priority_propagator = PriorityPropagator()
        self.auto_update = False
        self.use_cache = False
        # Fused fast path: compile the dirty ancestor closure of every
        # request into ONE fused XLA program instead of per-node dispatches.
        # Observable semantics (states, change feed, commit-time cancel,
        # use_cache eviction) are identical; auto_update graphs always use
        # the per-node path so incremental progress stays visible.
        self.fuse_subgraphs = True
        # recipe-hash memoization: nodes whose content recipe matches a
        # previously committed result are served from cache without device
        # work (see recipe_cache.py)
        self.memoize = True
        self._recipes: dict = {}  # NodeId → recipe hash (valid while Clean)
        self.buffer_queue = buffer_queue
        # engine wake callbacks: edits/requests kick the scheduler instead of
        # it polling at full rate while idle
        self._wakers: list = []
        # the owning processor's shutdown flag (set on registration):
        # blocking waits fail fast instead of spinning forever once the
        # engine is gone (the reference's await loops hang after shutdown)
        self._shutdown = None
        # set by the engine on a fatal kernel error (reference: engine panic,
        # `engine.rs:111-119`); awaits re-raise it instead of hanging.
        self.fatal_error: Optional[BaseException] = None
        # --- edit history (extension; the reference has no undo)
        # Every topology-mutating call — or one whole `write()` transaction —
        # journals a pre-edit snapshot (the serde structure of node_graph;
        # topology only, a few KB). `undo()`/`redo()` restore by MINIMAL
        # DIFF through the normal edit methods, so only genuinely affected
        # nodes re-dirty (and recompute) — an undo of a parameter drag costs
        # one cached-program re-run, not a whole-graph rebuild. Pixel data,
        # embedded/input slot datas, priorities, and flags are NOT journaled.
        # `history_capacity = 0` disables journaling entirely.
        self.history_capacity = 100
        self._undo_stack: list[dict] = []
        self._redo_stack: list[dict] = []
        self._txn_depth = 0
        self._txn_pre: Optional[dict] = None  # lazy pre-edit snapshot
        self._txn_eager = False

    # --- locking ---
    @contextmanager
    def read(self):
        with self._lock:
            yield self

    @contextmanager
    def write(self):
        with self._lock:
            with self._edit_unit():
                yield self

    # --- edit history (extension; see the block in `__init__`) ---
    @contextmanager
    def _edit_unit(self, eager: bool = False, capture: bool = False):
        """Group everything inside into ONE undo unit. Nested units (a
        mutating call inside `write()`, or apply-time edits during
        undo/redo) are absorbed by the outermost one. With `capture` False
        the pre-edit snapshot is taken lazily by the first mutating call
        inside (see `_journaled`), so read-only transactions cost nothing."""
        if self.history_capacity <= 0 or self._txn_depth > 0:
            yield
            return
        self._txn_depth += 1
        self._txn_pre = self._history_snapshot() if capture else None
        self._txn_eager = eager
        try:
            yield
        finally:
            self._txn_depth -= 1
            pre, eag = self._txn_pre, self._txn_eager
            self._txn_pre, self._txn_eager = None, False
            if pre is not None and (eag or self._history_snapshot() != pre):
                self._undo_stack.append(pre)
                self._redo_stack.clear()
                if len(self._undo_stack) > self.history_capacity:
                    del self._undo_stack[: -self.history_capacity]

    def _history_snapshot(self) -> dict:
        # serde structures are built fresh per call (node.py `to_json`), so
        # stored snapshots never alias live mutable state
        return self.node_graph.to_json()

    def undo_depth(self) -> int:
        with self._lock:
            return len(self._undo_stack)

    def redo_depth(self) -> int:
        with self._lock:
            return len(self._redo_stack)

    def clear_history(self) -> None:
        with self._lock:
            self._undo_stack.clear()
            self._redo_stack.clear()

    def undo(self) -> bool:
        """Revert the most recent edit unit. Returns False when there is
        nothing to undo. Affected nodes re-dirty through the normal edit
        machinery (in-flight work on them is cancelled at commit time,
        exactly like a live edit)."""
        with self._lock:
            return self._history_step(self._undo_stack, self._redo_stack)

    def redo(self) -> bool:
        """Re-apply the most recently undone edit unit."""
        with self._lock:
            return self._history_step(self._redo_stack, self._undo_stack)

    def _history_step(self, source: list, sink: list) -> bool:
        if not source:
            return False
        target = source.pop()
        current = self._history_snapshot()
        self._txn_depth += 1
        saved_pre, saved_eager = self._txn_pre, self._txn_eager
        try:
            self._apply_snapshot(target)
        except BaseException:
            source.append(target)  # keep the target available for retry
            raise
        finally:
            self._txn_pre, self._txn_eager = saved_pre, saved_eager
            self._txn_depth -= 1
        sink.append(current)
        if len(sink) > self.history_capacity:
            del sink[: -self.history_capacity]
        return True

    def _apply_snapshot(self, snap: dict) -> None:
        """Morph the live graph into `snap` by minimal diff, reusing the
        public edit methods so dirtying / cancellation / the `changed` feed
        behave exactly as if the user had made the inverse edits.

        Order matters for Input/Output name dedup (`_avoid_name_collision`
        runs on every add): removals, then in-place updates (bypassing
        dedup — target names are unique by construction), then adds (which
        can no longer collide), then edges."""
        tgt_nodes = {int(n["node_id"]): n for n in snap["nodes"]}
        tgt_edges = {
            (e["output_id"], e["input_id"], e["output_slot"], e["input_slot"])
            for e in snap["edges"]
        }
        for edge in list(self.node_graph.edges):
            key = (
                int(edge.output_id),
                int(edge.input_id),
                int(edge.output_slot),
                int(edge.input_slot),
            )
            if key not in tgt_edges:
                self.remove_edge(edge)
        cur_ids = {int(n.node_id) for n in self.node_graph.nodes}
        for nid in sorted(cur_ids - set(tgt_nodes)):
            self.remove_node(NodeId(nid))
        for nid in sorted(set(tgt_nodes) & cur_ids):
            live = self.node_graph._node_with_id_mut(NodeId(nid))
            if live.to_json() != tgt_nodes[nid]:
                fresh = Node.from_json(tgt_nodes[nid])
                live.node_type = fresh.node_type
                live.resize_policy = fresh.resize_policy
                live.resize_filter = fresh.resize_filter
                self._changed.add(NodeId(nid))
                self.set_state(NodeId(nid), NodeState.DIRTY)
                live.cancel.store(True)
        for nid in sorted(set(tgt_nodes) - cur_ids):
            self.add_node_with_id(Node.from_json(tgt_nodes[nid]))
        cur_edges = {
            (int(e.output_id), int(e.input_id), int(e.output_slot), int(e.input_slot))
            for e in self.node_graph.edges
        }
        for key in sorted(tgt_edges - cur_edges):
            self.connect(key[0], key[1], key[2], key[3])
        # restore list ORDER too, so the round-trip is serde-exact (node
        # order feeds input/output name listings and JSON byte-compat)
        norder = {int(n["node_id"]): i for i, n in enumerate(snap["nodes"])}
        self.node_graph.nodes.sort(key=lambda n: norder[int(n.node_id)])
        eorder = {
            (e["output_id"], e["input_id"], e["output_slot"], e["input_slot"]): i
            for i, e in enumerate(snap["edges"])
        }
        self.node_graph.edges.sort(
            key=lambda e: eorder[
                (int(e.output_id), int(e.input_id), int(e.output_slot), int(e.input_slot))
            ]
        )

    def _notify_state_change(self) -> None:
        with self._state_cv:
            self._state_cv.notify_all()
        for waker in self._wakers:
            waker()

    # --- blocking waits (`live_graph.rs:164-195`) ---
    @staticmethod
    @contextmanager
    def await_clean_write(live_graph: "LiveGraph", node_id: NodeId):
        while True:
            LiveGraph._await_clean(live_graph, node_id)
            with live_graph._lock:
                # re-check under the lock; retry if a concurrent edit dirtied it
                if live_graph.node_state(node_id) == NodeState.CLEAN:
                    yield live_graph
                    return

    await_clean_read = None  # assigned below (same implementation)

    @staticmethod
    def _await_clean(live_graph: "LiveGraph", node_id: NodeId) -> None:
        while True:
            with live_graph._lock:
                if live_graph.fatal_error is not None:
                    raise live_graph.fatal_error
                if live_graph.node_state(node_id) == NodeState.CLEAN:
                    return
                shutdown = live_graph._shutdown
                if shutdown is not None and shutdown.load():
                    raise TexProError(
                        ErrorKind.GENERIC, "TextureProcessor has shut down"
                    )
                live_graph.prioritise(node_id)
            with live_graph._state_cv:
                live_graph._state_cv.wait(timeout=0.002)

    # --- pixels out ---
    def buffer_rgba(self, node_id: NodeId, slot_id: SlotId):
        with self._lock:
            return self.slot_data(node_id, slot_id).image.to_u8()

    def buffer_srgba(self, node_id: NodeId, slot_id: SlotId):
        with self._lock:
            return self.slot_data(node_id, slot_id).image.to_u8_srgb()

    def try_buffer_rgba(self, node_id: NodeId, slot_id: SlotId):
        """Non-blocking read; submits a request when not clean
        (`live_graph.rs:98-124`)."""
        with self._lock:
            if self.node_state(node_id) == NodeState.CLEAN:
                return self.slot_data(node_id, slot_id).image.to_u8()
            self.request(node_id)
            raise TexProError(ErrorKind.NODE_DIRTY)

    def try_buffer_srgba(self, node_id: NodeId, slot_id: SlotId):
        """Non-blocking sRGB read (`live_graph.rs:127-153`)."""
        with self._lock:
            if self.node_state(node_id) == NodeState.CLEAN:
                return self.slot_data(node_id, slot_id).image.to_u8_srgb()
            self.request(node_id)
            raise TexProError(ErrorKind.NODE_DIRTY)

    # --- change feed ---
    def changed_consume(self) -> list[NodeId]:
        with self._lock:
            output = sorted(self._changed)
            self._changed.clear()
            return output

    # --- state machine ---
    def request(self, node_id: NodeId) -> None:
        with self._lock:
            state = self.node_state(node_id)
            if state == NodeState.DIRTY:
                self._node_state[node_id] = NodeState.REQUESTED
        for waker in self._wakers:
            waker()

    def prioritise(self, node_id: NodeId) -> None:
        with self._lock:
            state = self.node_state(node_id)
            if state in (NodeState.DIRTY, NodeState.REQUESTED):
                self._node_state[node_id] = NodeState.PRIORITISED
                changed = True
            else:
                changed = False
        if changed:
            for waker in self._wakers:
                waker()

    def node_states(self) -> dict[NodeId, NodeState]:
        with self._lock:
            return dict(self._node_state)

    def node_state(self, node_id: NodeId) -> NodeState:
        with self._lock:
            state = self._node_state.get(NodeId(node_id))
            if state is None:
                raise TexProError(ErrorKind.INVALID_NODE_ID)
            return state

    def node_ids_without_state(self, node_state: NodeState) -> list[NodeId]:
        with self._lock:
            return [nid for nid, s in sorted(self._node_state.items()) if s != node_state]

    def node_ids_with_state(self, node_state: NodeState) -> list[NodeId]:
        with self._lock:
            return [nid for nid, s in sorted(self._node_state.items()) if s == node_state]

    def get_closest_processable(self, node_id: NodeId) -> list[NodeId]:
        """Closest ready-to-process ancestors, including self
        (`live_graph.rs:279-311`). Iterative — deep chains must not hit the
        interpreter recursion limit."""
        with self._lock:
            closest: set[NodeId] = set()
            visited: set[NodeId] = set()
            stack = [node_id]
            while stack:
                current = stack.pop()
                if current in visited:
                    continue
                visited.add(current)
                dirty, processing = [], []
                for parent in self.node_graph.get_parents(current):
                    state = self.node_state(parent)
                    if state in _PROCESSINGISH:
                        processing.append(parent)
                    elif state in _DIRTYISH:
                        dirty.append(parent)
                if not dirty and not processing:
                    closest.add(current)
                else:
                    stack.extend(dirty)
            return sorted(closest)

    def set_state(self, node_id: NodeId, node_state: NodeState) -> None:
        """State write + dirty propagation to children + changed feed
        (`live_graph.rs:515-537`). Iterative dirty propagation."""
        with self._lock:
            changed_any = False
            stack = [node_id]
            while stack:
                current = stack.pop()
                old = self.node_state(current)
                if node_state == old:
                    continue
                if node_state == NodeState.DIRTY:
                    stack.extend(self.node_graph.get_children(current))
                if node_state == NodeState.DIRTY and old in (
                    NodeState.PROCESSING,
                    NodeState.PROCESSING_DIRTY,
                ):
                    # a SECOND dirty-propagation over an in-flight node must
                    # keep the PROCESSING_DIRTY marker — demoting it to plain
                    # DIRTY would let the stale in-flight result commit CLEAN
                    # with pre-edit pixels (served indefinitely: a Clean node
                    # never re-requests). PROCESSING_DIRTY == old is skipped
                    # by the equality check above only when node_state is
                    # also PROCESSING_DIRTY, so both cases land here.
                    self._node_state[current] = NodeState.PROCESSING_DIRTY
                else:
                    self._node_state[current] = node_state
                self._changed.add(current)
                changed_any = True
        if changed_any:
            self._notify_state_change()

    def force_state(self, node_id: NodeId, node_state: NodeState) -> None:
        """set_state + unconditional write, e.g. ProcessingDirty → Dirty
        (`live_graph.rs:542-549`)."""
        with self._lock:
            self.set_state(node_id, node_state)
            self._node_state[node_id] = node_state
        self._notify_state_change()

    def _set_state_raw(self, node_id: NodeId, node_state: NodeState) -> None:
        """Direct state write, no propagation/changed (engine dispatch marks
        Processing this way, `engine.rs:207-211`)."""
        with self._lock:
            self._node_state[node_id] = node_state
        self._notify_state_change()

    def redirty_for_recompute(self, node_id: NodeId) -> None:
        """Non-propagating Clean→Dirty for a node whose VALUE is unchanged
        but whose committed data was evicted (use_cache=False parent
        eviction, tier races): the recompute is bit-identical by the
        determinism contract, so descendants stay Clean and in-flight work
        keeps its results — a propagating set_state here cascaded a full
        subtree invalidation and discarded unrelated finished dispatches.
        Still feeds `changed` (the node's STATE did change, UI-visibly)."""
        with self._lock:
            self._node_state[node_id] = NodeState.DIRTY
            self._changed.add(node_id)
        self._notify_state_change()

    # --- priorities ---
    def propagate_priorities(self) -> None:
        with self._lock:
            self.priority_propagator.update(self.node_graph)

    # --- embedded / input slot data side channels ---
    def embedded_slot_datas(self) -> list[EmbeddedSlotData]:
        with self._lock:
            return list(self._embedded_slot_datas)

    def embed_slot_data_with_id(
        self, slot_data: SlotData, id: EmbeddedSlotDataId
    ) -> EmbeddedSlotDataId:
        with self._lock:
            if any(esd.slot_data_id == id for esd in self._embedded_slot_datas):
                raise TexProError(ErrorKind.INVALID_SLOT_ID)
            self.buffer_queue.add_slot_data(slot_data)
            self._embedded_slot_datas.append(EmbeddedSlotData.from_slot_data(slot_data, id))
            return id

    def input_slot_datas(self) -> list[SlotData]:
        with self._lock:
            return list(self._input_slot_datas)

    def add_input_slot_data(self, slot_data: SlotData) -> None:
        with self._lock:
            self.buffer_queue.add_slot_data(slot_data)
            self._input_slot_datas.append(slot_data)

    # --- results cache ---
    def remove_nodes_data(self, node_id: NodeId) -> None:
        with self._lock:
            self.slot_datas = [sd for sd in self.slot_datas if sd.node_id != node_id]

    def node_slot_datas(self, node_id: NodeId) -> list[SlotData]:
        with self._lock:
            return [sd for sd in self.slot_datas if sd.node_id == node_id]

    def slot_data(self, node_id: NodeId, slot_id: SlotId) -> SlotData:
        with self._lock:
            for sd in self.slot_datas:
                if sd.node_id == node_id and sd.slot_id == slot_id:
                    return sd
            raise TexProError(ErrorKind.NO_SLOT_DATA)

    def slot_data_size(self, node_id: NodeId, slot_id: SlotId) -> Size:
        return self.slot_data(node_id, slot_id).size()

    def slot_in_memory(self, node_id: NodeId, slot_id: SlotId) -> bool:
        return self.slot_data(node_id, slot_id).in_memory()

    # --- graph edits ---
    def has_node(self, node_id: NodeId) -> None:
        with self._lock:
            self.node_graph.has_node_with_id(node_id)

    def node(self, node_id: NodeId) -> Node:
        with self._lock:
            return self.node_graph.node(node_id)

    @_journaled(eager=True)
    def node_mut(self, node_id: NodeId) -> Node:
        """Marks the node dirty and returns the live (mutable) node object
        (`live_graph.rs:369-374`)."""
        with self._lock:
            self.set_state(node_id, NodeState.DIRTY)
            node = self.node_graph._node_with_id_mut(node_id)
            if node is None:
                raise TexProError(ErrorKind.INVALID_NODE_ID)
            return node

    @_journaled()
    def set_mix_type(self, node_id: NodeId, mix_type) -> None:
        """Change a Mix node's operator and dirty it (the reference's
        `NodeGraph::set_mix_type`, `node_graph.rs:48-63`, does not touch
        states; going through the LiveGraph keeps them consistent)."""
        with self._lock:
            self.node_graph.set_mix_type(node_id, mix_type)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_blur_sigma(self, node_id: NodeId, sigma: float) -> None:
        """Change a Blur node's sigma and dirty it (extension node)."""
        with self._lock:
            self.node_graph.set_blur_sigma(node_id, sigma)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_hsv(self, node_id: NodeId, hue, saturation, value) -> None:
        """Change an Hsv node's adjust parameters and dirty it (extension
        node; slider drags re-run a cached program)."""
        with self._lock:
            self.node_graph.set_hsv(node_id, hue, saturation, value)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_distance(self, node_id: NodeId, max_dist: float) -> None:
        """Change a Distance node's spread and dirty it (extension node;
        spread drags re-run a cached program)."""
        with self._lock:
            self.node_graph.set_distance(node_id, max_dist)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_ambient_occlusion(self, node_id: NodeId, strength: float,
                              radius: float) -> None:
        """Change an AmbientOcclusion node's parameters and dirty it
        (extension node; strength drags re-run a cached program, a radius
        edit re-bakes the Gaussian taps)."""
        with self._lock:
            self.node_graph.set_ambient_occlusion(node_id, strength, radius)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_curvature(self, node_id: NodeId, strength: float) -> None:
        """Change a Curvature node's strength and dirty it (extension node;
        slider drags re-run a cached program)."""
        with self._lock:
            self.node_graph.set_curvature(node_id, strength)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_levels(self, node_id: NodeId, in_lo, in_hi, gamma, out_lo, out_hi) -> None:
        """Change a Levels node's remap parameters and dirty it (extension
        node; slider drags re-run a cached program)."""
        with self._lock:
            self.node_graph.set_levels(node_id, in_lo, in_hi, gamma, out_lo, out_hi)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_noise(self, node_id: NodeId, width, height, cells=8, octaves=4,
                  seed=0, persistence=0.5) -> None:
        """Change a Noise node's parameters and dirty it (extension node;
        seed/persistence/cells edits re-run a cached program)."""
        with self._lock:
            self.node_graph.set_noise(
                node_id, width, height, cells, octaves, seed, persistence
            )
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_pattern(self, node_id: NodeId, width, height, pattern="Checker",
                    cells_x=8, cells_y=8, mortar=0.0, bevel=0.0,
                    seed=0) -> None:
        """Change a Pattern node's parameters and dirty it (extension node;
        cells/mortar/bevel/seed edits re-run a cached program)."""
        with self._lock:
            self.node_graph.set_pattern(
                node_id, width, height, pattern, cells_x, cells_y,
                mortar, bevel, seed
            )
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_voronoi(self, node_id: NodeId, width, height, cells_x=8,
                    cells_y=8, jitter=1.0, seed=0) -> None:
        """Change a Voronoi node's parameters and dirty it (extension node;
        cells/jitter/seed edits re-run a cached program)."""
        with self._lock:
            self.node_graph.set_voronoi(
                node_id, width, height, cells_x, cells_y, jitter, seed
            )
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_ramp(self, node_id: NodeId, width, height, kind="Linear",
                 angle=0.0, cx=0.5, cy=0.5, scale=1.0) -> None:
        """Change a Ramp node's parameters and dirty it (extension node;
        angle/center/scale edits re-run a cached program; size/kind edits
        retrace)."""
        with self._lock:
            self.node_graph.set_ramp(
                node_id, width, height, kind, angle, cx, cy, scale
            )
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_transform(self, node_id: NodeId, offset_x, offset_y, rotation,
                      scale_x, scale_y) -> None:
        """Change a Transform node's placement and dirty it (extension
        node; drags re-run a cached program)."""
        with self._lock:
            self.node_graph.set_transform(
                node_id, offset_x, offset_y, rotation, scale_x, scale_y
            )
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_warp(self, node_id: NodeId, angle, intensity) -> None:
        """Change a Warp node's direction/intensity and dirty it (extension
        node; drags re-run a cached program)."""
        with self._lock:
            self.node_graph.set_warp(node_id, angle, intensity)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_gradient_map(self, node_id: NodeId, stops) -> None:
        """Change a GradientMap node's stops and dirty it (extension node;
        same-count stop edits re-run a cached program)."""
        with self._lock:
            self.node_graph.set_gradient_map(node_id, stops)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_image_node_path(self, node_id: NodeId, path) -> None:
        """Change an Image node's source path and dirty it
        (`node_graph.rs:65-83`)."""
        with self._lock:
            self.node_graph.set_image_node_path(node_id, path)
            self.set_state(node_id, NodeState.DIRTY)
            self.node(node_id).cancel.store(True)

    @_journaled()
    def set_node_with_id(self, node_id: NodeId, node: Node) -> None:
        with self._lock:
            index = self.node_graph._index_of_node(node_id)
            if index is None:
                raise TexProError(ErrorKind.INVALID_NODE_ID)
            self.node_graph.nodes[index] = node

    def new_id(self) -> NodeId:
        with self._lock:
            return self.node_graph.new_id()

    @_journaled()
    def add_node(self, node: Node) -> NodeId:
        with self._lock:
            priority = node.priority
            node_id = self.node_graph.add_node(node)
            self._add_node_internal(priority, node_id)
            return node_id

    @_journaled()
    def add_node_with_id(self, node: Node) -> None:
        with self._lock:
            priority = node.priority
            node_id = node.node_id
            self.node_graph.add_node_with_id(node)
            self._add_node_internal(priority, node_id)

    def _add_node_internal(self, priority, node_id: NodeId) -> None:
        self._changed.add(node_id)
        self._node_state[node_id] = NodeState.DIRTY
        self.priority_propagator.push_priority(node_id, priority)

    @_journaled()
    def remove_node(self, node_id: NodeId) -> list:
        """Remove a node; its consumers (and their descendants) are dirtied
        and their cached pixels dropped. The reference only inserts them into
        the `changed` UI set (`live_graph.rs:452-476`) and leaves them Clean
        with stale pixels — a correctness bug its tests never hit because
        they only remove unconnected nodes; fixed here like `remove_edge`."""
        with self._lock:
            dirty_nodes = sorted(set(self.node_graph.get_children_recursive(node_id)))

            _, edges = self.node_graph.remove_node(node_id)
            self._changed.add(node_id)
            for input_id in sorted({e.input_id for e in edges}):
                self._changed.add(input_id)
            self.remove_nodes_data(node_id)
            self._node_state.pop(node_id, None)
            self._recipes.pop(node_id, None)

            for child in dirty_nodes:
                self.set_state(child, NodeState.DIRTY)
                self.node(child).cancel.store(True)
                self.remove_nodes_data(child)
            return edges

    def can_connect(self, output_node, input_node, output_slot, input_slot) -> None:
        with self._lock:
            self.node_graph.can_connect(output_node, input_node, output_slot, input_slot)

    @_journaled()
    def connect(self, output_node, input_node, output_slot, input_slot):
        """Connect + dirty input subtree + cancel in-flight work on the input
        node (`live_graph.rs:488-511`)."""
        with self._lock:
            edge = self.node_graph.connect(
                NodeId(output_node), NodeId(input_node), SlotId(output_slot), SlotId(input_slot)
            )
            self._changed.add(NodeId(input_node))
            self.node(output_node).priority.touch()
            self.set_state(NodeId(input_node), NodeState.DIRTY)
            try:
                node = self.node(input_node)
            except TexProError:
                raise TexProError(ErrorKind.INVALID_NODE_ID)
            node.cancel.store(True)
            return edge

    @_journaled()
    def remove_edge(self, edge) -> "Edge":
        with self._lock:
            dirty_nodes = self.node_graph.get_children_recursive(edge.input_id)
            dirty_nodes.append(edge.input_id)
            dirty_nodes = sorted(set(dirty_nodes))

            edge = self.node_graph.remove_edge(edge)

            for node_id in dirty_nodes:
                self.set_state(node_id, NodeState.DIRTY)
                self.node(edge.output_id).priority.touch()
                self.remove_nodes_data(node_id)
            return edge

    @_journaled()
    def disconnect_slot(self, node_id: NodeId, side: Side, slot_id: SlotId) -> list:
        with self._lock:
            edges = self.node_graph.disconnect_slot(NodeId(node_id), side, SlotId(slot_id))
            dirty_nodes = []
            for edge in edges:
                # the CONSUMER itself must re-evaluate (its input set
                # changed); get_children_recursive excludes the start node,
                # and leaving it Clean would serve pixels computed from an
                # edge that no longer exists (the same stale-Clean class the
                # port fixes in remove_node)
                dirty_nodes.append(edge.input_id)
                dirty_nodes.extend(self.node_graph.get_children_recursive(edge.input_id))
                self.node(edge.output_id).priority.touch()
                try:
                    self.node(edge.input_id).cancel.store(True)
                except TexProError:
                    pass
            if side == Side.INPUT:
                dirty_nodes.append(NodeId(node_id))
            else:
                self._changed.add(NodeId(node_id))
            for nid in sorted(set(dirty_nodes)):
                self.set_state(nid, NodeState.DIRTY)
            return edges

    def connected_edges(self, node_id: NodeId, side: Side, slot_id: SlotId) -> list:
        with self._lock:
            return self.node_graph.connected_edges(node_id, side, slot_id)

    @_journaled()
    def set_node_graph(self, node_graph: NodeGraph) -> None:
        with self._lock:
            # A cyclic graph would never become processable and hang every
            # waiter (ADVICE r1); reject it up front.
            node_graph.validate_acyclic()
            # ids in flight for the OLD graph: a result committing after the
            # swap would otherwise land on the NEW graph's same-id node and
            # mark it Clean with the old graph's pixels. Setting the new
            # node's cancel flag makes the commit-time check discard it
            # (`engine.rs:77-102` semantics; a legitimate new dispatch
            # un-cancels on admission).
            in_flight = {
                nid
                for nid, state in self._node_state.items()
                if state in (NodeState.PROCESSING, NodeState.PROCESSING_DIRTY)
            }
            self.node_graph = node_graph
            self.reset_node_states()
            self.slot_datas.clear()
            self._recipes.clear()
            for node in node_graph.nodes:
                self.priority_propagator.push_priority(node.node_id, node.priority)
                if node.node_id in in_flight:
                    node.cancel.store(True)

    def reset_node_states(self) -> None:
        with self._lock:
            self._node_state = {nid: NodeState.default() for nid in self.node_ids()}

    def output_ids(self) -> list[NodeId]:
        with self._lock:
            return self.node_graph.output_ids()

    @_journaled()
    def rename_output_node(self, node_id: NodeId, new_name: str) -> str:
        with self._lock:
            return self.node_graph.rename_output_node(node_id, new_name)

    def node_ids(self) -> list[NodeId]:
        with self._lock:
            return self.node_graph.node_ids()

    def edges(self) -> list:
        with self._lock:
            return list(self.node_graph.edges)


# await_clean_read has identical semantics to await_clean_write under a single
# reentrant lock (shared reads gain nothing under the GIL).
LiveGraph.await_clean_read = LiveGraph.await_clean_write
