"""Pin the public API surface PARITY.md claims to actual code.

The parity table ("Public API surface (reference `lib.rs` re-exports)")
asserts every reference method name exists here under the same name; this
test walks those lists with `hasattr` so a rename or deletion fails CI
instead of silently invalidating the document. Reference surface:
`/root/reference/src/texture_processor.rs`, `live_graph.rs`,
`node_graph.rs`, `lib.rs` (module re-exports).
"""

import kanter_core_tpu as k
from kanter_core_tpu import LiveGraph, NodeGraph, TextureProcessor

TEXTURE_PROCESSOR = [
    "new_live_graph", "push_live_graph", "live_graphs_snapshot", "buffer_rgba",
    "node_slot_datas", "await_slot_data_size", "processing_node_count",
    "set_max_processing_nodes", "shutdown_now",
]

# reference pub fields surfaced as instance attributes (AtomicBool/AtomicUsize)
TEXTURE_PROCESSOR_ATTRS = ["shutdown", "memory_threshold"]

LIVE_GRAPH = [
    "add_node", "add_node_with_id", "connect", "can_connect", "remove_node",
    "remove_edge", "disconnect_slot", "connected_edges", "request", "prioritise",
    "await_clean_read", "await_clean_write", "buffer_rgba", "try_buffer_rgba",
    "try_buffer_srgba", "buffer_srgba", "slot_data", "slot_data_size",
    "slot_in_memory", "node_slot_datas", "changed_consume",
    "embed_slot_data_with_id", "add_input_slot_data", "node", "node_mut",
    "set_node_with_id", "new_id", "set_node_graph", "reset_node_states",
    "output_ids", "rename_output_node", "node_ids", "edges", "node_state",
    "node_states", "node_ids_with_state", "node_ids_without_state",
    "get_closest_processable", "set_mix_type", "set_image_node_path",
]

NODE_GRAPH = [
    "from_path", "export_json", "add_node", "add_node_with_id", "connect",
    "try_connect", "can_connect", "remove_node", "remove_edge",
    "disconnect_slot", "connected_edges", "slot_occupied", "get_parents",
    "get_children", "get_children_recursive", "input_slots", "output_slots",
    "input_ids", "output_ids", "input_nodes", "output_nodes", "input_names",
    "output_names", "rename_output_node", "input_slot_id_with_name",
    "output_slot_id_with_name", "set_mix_type", "set_image_node_path",
    "new_id", "node", "node_ids", "has_node_with_id", "edge_indices_slot",
    "input_edges",
]

TOP_LEVEL = [
    # reference lib.rs re-exported types (`/root/reference/src/lib.rs`)
    "Node", "NodeType", "MixType", "ResizePolicy", "ResizeFilter", "Side",
    "SlotType", "Slot", "NodeId", "SlotId", "Edge", "Size", "SlotData",
    "SlotImage", "TexProError", "ErrorKind", "Priority", "NodeState",
    # extension additions documented in PARITY.md
    "CompiledGraph", "compile_graph",
]


def test_texture_processor_surface():
    missing = [m for m in TEXTURE_PROCESSOR if not hasattr(TextureProcessor, m)]
    assert not missing, f"TextureProcessor lost API methods: {missing}"
    tp = TextureProcessor(1_000_000)
    try:
        missing = [a for a in TEXTURE_PROCESSOR_ATTRS if not hasattr(tp, a)]
        assert not missing, f"TextureProcessor lost attributes: {missing}"
    finally:
        tp.shutdown_now()


def test_parallel_surface():
    from kanter_core_tpu.parallel import BatchedGraph, BatchedLiveSession  # noqa: F401


def test_live_graph_surface():
    missing = [m for m in LIVE_GRAPH if not hasattr(LiveGraph, m)]
    assert not missing, f"LiveGraph lost API methods: {missing}"


def test_node_graph_surface():
    missing = [m for m in NODE_GRAPH if not hasattr(NodeGraph, m)]
    assert not missing, f"NodeGraph lost API methods: {missing}"


def test_top_level_exports():
    missing = [name for name in TOP_LEVEL if not hasattr(k, name)]
    assert not missing, f"package lost top-level exports: {missing}"
