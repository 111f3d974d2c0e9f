"""Dispatch admission control.

Port of `/root/reference/src/process_pack.rs`: the manager keeps the set of
in-flight node dispatches sorted by propagated priority, caps it at
`max_count`, and preempts — higher-priority work cancels (via the node's
cancel flag) the lowest-priority running node (`process_pack.rs:53-89`). On
a device, "running" means an enqueued/dispatched XLA program; preemption drops
queued dispatches — an in-flight device kernel is never aborted, and the
commit-time cancel check discards its result (`engine.rs:80-102`).

The reference caps at `num_cpus` (`process_pack.rs:27`); workers here are
dispatch threads (the device does the math), and nested Graph nodes *block* a
slot while their inner graph runs, so the default is at least 8 to keep
deeply-nested graphs live even on small hosts.
"""

from __future__ import annotations

import os

from .errors import ErrorKind, TexProError
from .live_graph import LiveGraph, NodeState


class ProcessPack:
    __slots__ = ("node_id", "priority", "live_graph")

    def __init__(self, node_id, priority, live_graph: LiveGraph):
        self.node_id = node_id
        self.priority = priority
        self.live_graph = live_graph


def default_max_count() -> int:
    return max(os.cpu_count() or 1, 8)


class ProcessPackManager:
    def __init__(self):
        self.process_packs: list[ProcessPack] = []
        self.max_count = default_max_count()

    @staticmethod
    def _is_graph_pack(pack: ProcessPack) -> bool:
        """Graph-node packs don't occupy admission slots: their worker
        BLOCKS awaiting the nested graph's outputs rather than computing, so
        counting them starves the very inner dispatches they wait on — with
        max_count blocked Graph nodes the processor would deadlock
        permanently (inner packs at equal priority can never strictly
        preempt). Same rationale as the unbounded worker pool
        (`engine._WorkerPool`)."""
        from .node import NodeTypeKind

        # non-cloning kind read: `node()` deep-clones (a GRAPH pack would
        # copy its whole nested NodeGraph payload) and this runs O(packs^2)
        # per admission update on the scheduler tick
        with pack.live_graph._lock:
            kind = pack.live_graph.node_graph.node_kind(pack.node_id)
        return kind == NodeTypeKind.GRAPH

    def _occupied(self) -> int:
        return sum(1 for p in self.process_packs if not self._is_graph_pack(p))

    def update(self, process_packs: list[ProcessPack]) -> list[ProcessPack]:
        """Admit as many of the given packs as fit; returns the admitted ones
        (`process_pack.rs:33-96`). Graph-node packs bypass the cap (see
        `_is_graph_pack`)."""
        output_packs: list[ProcessPack] = []
        self._remove_clean()
        self._sort_by_priority(self.process_packs)
        excess = self._occupied() - self.max_count
        if excess > 0:
            kept = []
            for p in self.process_packs:  # ascending priority: drop coldest
                if excess > 0 and not self._is_graph_pack(p):
                    excess -= 1
                    continue
                kept.append(p)
            self.process_packs = kept

        self._sort_by_priority(process_packs)

        while process_packs:
            pack = process_packs.pop()  # highest priority first
            # one slot per (graph, node): a re-request of a node whose stale
            # pack still lingers replaces it instead of stacking duplicates
            # until the cap deadlocks admission
            for i, existing in enumerate(self.process_packs):
                if existing.live_graph is pack.live_graph and existing.node_id == pack.node_id:
                    del self.process_packs[i]
                    break
            lowest = next(
                (p for p in self.process_packs if not self._is_graph_pack(p)), None
            )
            if self._is_graph_pack(pack) or self._occupied() < self.max_count:
                if not self._insert_by_priority(pack):
                    continue  # node deleted
                output_packs.append(pack)
            elif (
                lowest is not None
                and pack.priority.propagated_priority()
                > lowest.priority.propagated_priority()
            ):
                if not self._insert_by_priority(pack):
                    continue
                self.process_packs.remove(lowest)
                try:
                    lowest.live_graph.node(lowest.node_id).cancel.store(True)
                except TexProError as e:
                    if e.kind == ErrorKind.INVALID_NODE_ID:
                        continue  # node removed
                    raise
                output_packs.append(pack)
            else:
                # can't admit this one, but lower-priority GRAPH packs
                # further down still bypass the cap — keep scanning
                continue

        return output_packs

    def _remove_clean(self) -> None:
        # The reference removes only Clean packs (`process_pack.rs:98-117`),
        # which leaks slots when a node is committed and immediately
        # re-dirtied by the next edit before a scheduler tick observes the
        # Clean state — after max_count such cycles the manager is full of
        # dead packs and admission deadlocks. A pack whose node is Dirty is
        # equally settled (its dispatch finished or was discarded), so it
        # frees its slot too.
        for i in reversed(range(len(self.process_packs))):
            pack = self.process_packs[i]
            try:
                state = pack.live_graph.node_state(pack.node_id)
            except TexProError:
                del self.process_packs[i]
                continue
            if state in (NodeState.CLEAN, NodeState.DIRTY):
                del self.process_packs[i]

    def _insert_by_priority(self, pack: ProcessPack) -> bool:
        """Insert sorted; un-cancels the node so previously preempted work can
        run (`process_pack.rs:121-129`). False if the node no longer exists."""
        try:
            pack.live_graph.node(pack.node_id).cancel.store(False)
        except TexProError as e:
            if e.kind == ErrorKind.INVALID_NODE_ID:
                return False
            raise

        key = pack.priority.propagated_priority()
        pos = len(self.process_packs)
        for i, existing in enumerate(self.process_packs):
            if existing.priority.propagated_priority() >= key:
                pos = i
                break
        self.process_packs.insert(pos, pack)
        return True

    @staticmethod
    def _sort_by_priority(packs: list[ProcessPack]) -> None:
        packs.sort(key=lambda p: p.priority.propagated_priority())
