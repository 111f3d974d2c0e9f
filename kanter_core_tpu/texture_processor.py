"""Public facade: owns live graphs, the scheduler, and the memory manager.

Mirrors `/root/reference/src/texture_processor.rs`: construction spawns the
scheduler loop and the buffer-queue manager as daemon threads
(`texture_processor.rs:52-53`); dropping the processor flips the shutdown flag
(`:27-31`). Here it is also a context manager for deterministic teardown.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from .engine import Engine
from .errors import ErrorKind, TexProError
from .ids import NodeId, SlotId
from .live_graph import LiveGraph
from .node import AtomicFlag
from .process_pack import ProcessPackManager
from .profiling import NodeTimeline
from .slot_data import Size, SlotData
from .transient_buffer import AtomicUsize, PlaneBufferQueue


class TextureProcessor:
    def __init__(
        self,
        memory_threshold=10_000_000,
        host_memory_threshold: Optional[int] = None,
        mesh=None,
        tile_bytes: Optional[int] = None,
        bucket_sizes: bool = False,
        precision=None,
    ):
        """`mesh`: an optional `jax.sharding.Mesh`. When set, the engine's
        fused-partition dispatches place every large plane row-sharded over
        the mesh's FIRST axis, so the interactive LiveGraph path itself
        scales across devices (GSPMD inserts the halo exchanges for stencil
        ops; sharded execution is bit-identical to single-device — enforced
        by tests/test_mesh_engine.py). This replaces the reference's
        thread-per-node scaling (`engine.rs:288-306`) at the multi-device
        level.

        `tile_bytes`: optional device working-set budget in bytes. Fused
        partitions whose dense result footprint exceeds it are evaluated in
        row bands (`kanter_core_tpu.tiled`) with halos, bit-identically, so
        canvases larger than device memory still evaluate — the reference
        can only spill whole finished planes (`transient_buffer.rs:388-406`)
        and cannot process a working set bigger than memory at all. Composes
        with `mesh`: each band's row axis is itself GSPMD-sharded across the
        mesh (capacity × scale).

        `bucket_sizes`: opt-in interactive sizing mode — fused partitions of
        bucketable ops evaluate through the shape-bucketed path
        (`kanter_core_tpu.bucketed`), so a canvas-size drag (SpecificSize
        edits) recompiles once per size BUCKET instead of once per pixel
        size, bit-identically. Trade-offs: plane aliasing across outputs is
        not preserved (sliced copies), and device memory briefly holds the
        padded planes.

        `precision`: pipeline storage dtype (DESIGN.md §9). None/"float32"
        (default) is the bit-exact reference pipeline. "bfloat16" is the
        opt-in half-precision FOOTPRINT mode — bf16 at rest, f32 in
        flight: planes commit at bf16 (half the device working set,
        host/disk tier footprint, and eviction/checkpoint/transfer bytes)
        while every kernel computes the same f32 math as the default
        pipeline, so u8 exports differ by at most a few LSB and outputs
        bit-match the f32 pipeline on bf16-quantized leaves. Its throughput
        on the GPU is not measured yet (DESIGN.md §9). The capacity (tiled) and bucketed fallback
        paths keep evaluating in f32 and interoperate (bf16 boundary
        planes upcast at the binding funnel)."""
        if not isinstance(memory_threshold, AtomicUsize):
            memory_threshold = AtomicUsize(memory_threshold)
        self.memory_threshold = memory_threshold
        self.mesh = mesh
        self.tile_bytes = tile_bytes
        self.bucket_sizes = bucket_sizes
        from .compiler import resolve_dtype

        self.precision = resolve_dtype(precision)
        self.host_memory_threshold = (
            AtomicUsize(host_memory_threshold) if host_memory_threshold is not None else None
        )
        self.shutdown = AtomicFlag(False)
        self.buffer_queue = PlaneBufferQueue(
            self.memory_threshold, self.shutdown, self.host_memory_threshold
        )
        self._live_graphs: list[LiveGraph] = []
        self._live_graphs_lock = threading.Lock()
        self._process_pack_manager = ProcessPackManager()
        self._ppm_lock = threading.Lock()
        self.timeline = NodeTimeline()
        from .recipe_cache import RecipeCache

        self.recipe_cache = RecipeCache()
        self.engine = Engine(self)

        self._engine_thread = threading.Thread(
            target=self.engine.run, daemon=True, name="kanter-engine"
        )
        self._buffer_thread = threading.Thread(
            target=self.buffer_queue.thread_loop, daemon=True, name="kanter-memory"
        )
        self._engine_thread.start()
        self._buffer_thread.start()

    # --- lifecycle ---
    def shutdown_now(self) -> None:
        self.shutdown.store(True)
        self.engine.wake()
        for live_graph in self.live_graphs_snapshot():
            live_graph._notify_state_change()  # wake any blocked awaits
        # join the daemons (bounded): a daemon thread killed by interpreter
        # exit while inside a device transfer aborts the process from C++
        # ("FATAL: exception not rethrown"), poisoning benchmark/driver exit
        # codes. The manager in particular may be mid np.asarray since tier
        # transfers run outside its lock.
        for thread in (self._engine_thread, self._buffer_thread):
            if thread is not None and thread.is_alive():
                # the manager abandons queued transfers on shutdown, so the
                # wait is bounded by ONE in-flight device→host copy
                thread.join(timeout=60.0)

    def __enter__(self) -> "TextureProcessor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown_now()

    def __del__(self):
        try:
            self.shutdown.store(True)
        except Exception:
            pass

    # --- live graph management ---
    def new_live_graph(self) -> LiveGraph:
        live_graph = LiveGraph(self.buffer_queue)
        live_graph._wakers.append(self.engine.wake)
        live_graph._shutdown = self.shutdown
        with self._live_graphs_lock:
            self._live_graphs.append(live_graph)
        return live_graph

    def push_live_graph(self, live_graph: LiveGraph) -> None:
        if self.engine.wake not in live_graph._wakers:
            live_graph._wakers.append(self.engine.wake)
        live_graph._shutdown = self.shutdown
        with self._live_graphs_lock:
            self._live_graphs.append(live_graph)
        self.engine.wake()

    def remove_live_graph(self, live_graph: LiveGraph) -> None:
        with self._live_graphs_lock:
            self._live_graphs = [lg for lg in self._live_graphs if lg is not live_graph]

    def live_graphs_snapshot(self) -> list[LiveGraph]:
        with self._live_graphs_lock:
            return list(self._live_graphs)

    def has_live_graph(self, live_graph: LiveGraph) -> bool:
        with self._live_graphs_lock:
            return any(lg is live_graph for lg in self._live_graphs)

    def drop_unused_live_graphs(self) -> None:
        """Drop graphs no external code references (reference: Arc strong
        count of 1, `live_graph.rs:637-645`). CPython refcount heuristic:
        list entry + comprehension variable + getrefcount argument = 3."""
        with self._live_graphs_lock:
            self._live_graphs = [lg for lg in self._live_graphs if sys.getrefcount(lg) > 3]

    # --- admission control ---
    def update_process_packs(self, packs):
        with self._ppm_lock:
            try:
                return self._process_pack_manager.update(packs)
            except TexProError:
                self.shutdown.store(True)
                return None

    def processing_node_count(self) -> int:
        with self._ppm_lock:
            return len(self._process_pack_manager.process_packs)

    def set_max_processing_nodes(self, count: int) -> None:
        with self._ppm_lock:
            self._process_pack_manager.max_count = int(count)

    def metrics(self) -> dict:
        """Observability snapshot: buffer-tier bytes, in-flight dispatches,
        per-node-kind timing summary, fused-program cache size."""
        return {
            "precision": self.precision.name,
            "bytes_device": self.buffer_queue.bytes_memory(),
            "bytes_host": self.buffer_queue.bytes_host(),
            "bytes_storage": self.buffer_queue.bytes_storage(),
            "processing_node_count": self.processing_node_count(),
            "fused_programs": len(self.engine._fused_programs),
            "tiled_programs": len(self.engine._tiled_programs),
            "recipe_cache": self.recipe_cache.stats(),
            "timeline": self.timeline.summary(),
        }

    # --- blocking getters (`texture_processor.rs:75-105`) ---
    @staticmethod
    def buffer_rgba(live_graph: LiveGraph, node_id: NodeId, slot_id: SlotId):
        with LiveGraph.await_clean_write(live_graph, node_id) as lg:
            slot_data = lg.slot_data(node_id, slot_id)
        # the u8 export dispatches device work + a data readback — run it
        # OUTSIDE the graph lock so the
        # engine loop and editors aren't frozen for the duration. The
        # SlotData snapshot holds its plane refs; a concurrent edit can't
        # invalidate the pixels it already references.
        return slot_data.image.to_u8()

    @staticmethod
    def node_slot_datas(live_graph: LiveGraph, node_id: NodeId) -> list[SlotData]:
        with LiveGraph.await_clean_write(live_graph, node_id) as lg:
            return lg.node_slot_datas(node_id)

    @staticmethod
    def await_slot_data_size(live_graph: LiveGraph, node_id: NodeId, slot_id: SlotId) -> Size:
        while True:
            # re-prioritise EVERY pass (like `_await_clean`'s spin,
            # `live_graph.rs:168-178`): a mid-flight edit can discard the
            # result and drop the node back to Dirty with no one requesting
            # it — a one-shot prioritise would then wait forever
            with live_graph.write() as lg:
                if lg.fatal_error is not None:
                    raise lg.fatal_error
                # guard None like _await_clean: a LiveGraph never pushed
                # onto a processor has no shutdown flag yet
                if lg._shutdown is not None and lg._shutdown.load():
                    raise TexProError(
                        ErrorKind.NODE_PROCESSING,
                        "texture processor is shut down; slot data will never arrive",
                    )
                try:
                    return lg.slot_data_size(node_id, slot_id)
                except TexProError as e:
                    if e.kind != ErrorKind.NO_SLOT_DATA:
                        raise
                lg.prioritise(node_id)
            with live_graph._state_cv:
                live_graph._state_cv.wait(timeout=0.002)
