"""Full checkpoint/resume for live graphs.

The reference persists *topology only* (`export_json`, `node_graph.rs:98-107`);
resume reloads the JSON with every node Dirty and recomputes everything
(SURVEY §5). That path exists here too (`NodeGraph.export_json/from_path`).

This module goes further: `save_checkpoint` captures a LiveGraph's topology,
per-node states, engine flags, input/embedded slot data registrations, and
the computed channel planes (deduplicated — shared planes are stored once
and re-aliased on load), so `load_checkpoint` resumes with Clean nodes still
clean and zero recompute, and Input/Embed nodes can reprocess. Priorities
and cancel flags reset on load, matching the reference's `#[serde(skip)]`
fields (`node/mod.rs:119-122`).
"""

from __future__ import annotations

import json

import numpy as np

from .ids import NodeId, SlotId
from .live_graph import LiveGraph, NodeState
from .node_graph import NodeGraph
from .slot_data import SlotData
from .slot_image import SlotImage
from .transient_buffer import plane_from_host


def save_checkpoint(live_graph: LiveGraph, path: str) -> None:
    with live_graph.read() as lg:
        graph_json = lg.node_graph.to_json()
        states = {str(int(nid)): state.value for nid, state in lg.node_states().items()}

        plane_index: dict[int, int] = {}  # id(plane) → array index
        plane_objs: list = []

        def image_planes(image):
            plane_ids = []
            for plane in image.planes:
                key = id(plane)
                if key not in plane_index:
                    plane_index[key] = len(plane_objs)
                    plane_objs.append(plane)
                plane_ids.append(plane_index[key])
            return plane_ids

        slots = [
            {
                "node_id": int(sd.node_id),
                "slot_id": int(sd.slot_id),
                "planes": image_planes(sd.image),
            }
            for sd in lg.slot_datas
        ]
        input_slots = [
            {
                "node_id": int(sd.node_id),
                "slot_id": int(sd.slot_id),
                "planes": image_planes(sd.image),
            }
            for sd in lg.input_slot_datas()
        ]
        embedded = [
            {
                "id": int(esd.slot_data_id),
                "slot_id": int(esd.slot_id),
                "planes": image_planes(esd.image),
            }
            for esd in lg.embedded_slot_datas()
        ]

        meta = {
            "graph": graph_json,
            "states": states,
            "slots": slots,
            "input_slots": input_slots,
            "embedded": embedded,
            "auto_update": lg.auto_update,
            "use_cache": lg.use_cache,
            "fuse_subgraphs": lg.fuse_subgraphs,
            "memoize": lg.memoize,
        }

    # The device→host materializations run OUTSIDE the graph lock: a plane's
    # contents are immutable after commit (commits replace whole SlotData
    # objects; planes only transition tiers, under their own locks), and a
    # multi-GB checkpoint can take seconds to copy out —
    # holding the LiveGraph lock across it would block every edit, request,
    # and engine commit for the duration. Only the graph SNAPSHOT (topology,
    # states, plane references) needs the lock.
    arrays = [plane.host_data() for plane in plane_objs]

    # np.savez cannot serialize ml_dtypes arrays (bf16 pipeline planes,
    # DESIGN.md §9): store those as a bit-preserving uint16 view plus a
    # dtype tag in the manifest
    plane_dtypes = []
    encoded = []
    for arr in arrays:
        plane_dtypes.append(arr.dtype.name)
        encoded.append(arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr)
    meta["plane_dtypes"] = plane_dtypes

    # pass a file object: np.savez with a bare path silently appends ".npz"
    # when the extension differs, so save("x.ckpt") would write "x.ckpt.npz"
    # while load opens "x.ckpt"
    with open(path, "wb") as f:
        np.savez_compressed(
            f,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **{f"plane_{i}": arr for i, arr in enumerate(encoded)},
        )


def load_checkpoint(tex_pro, path: str) -> LiveGraph:
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        planes = {}

        live_graph = tex_pro.new_live_graph()
        with live_graph.write() as lg:
            lg.set_node_graph(NodeGraph.from_json(meta["graph"]))
            lg.auto_update = meta["auto_update"]
            lg.use_cache = meta["use_cache"]
            lg.fuse_subgraphs = meta.get("fuse_subgraphs", True)
            lg.memoize = meta.get("memoize", True)

            plane_dtypes = meta.get("plane_dtypes")

            def plane(i: int):
                if i not in planes:
                    arr = data[f"plane_{i}"]
                    if plane_dtypes and plane_dtypes[i] == "bfloat16":
                        import ml_dtypes

                        arr = arr.view(ml_dtypes.bfloat16)
                    planes[i] = plane_from_host(arr)
                return planes[i]

            for slot in meta["slots"]:
                image = SlotImage([plane(i) for i in slot["planes"]])
                slot_data = SlotData(NodeId(slot["node_id"]), SlotId(slot["slot_id"]), image)
                lg.slot_datas.append(slot_data)
                tex_pro.buffer_queue.add_slot_data(slot_data)

            for slot in meta.get("input_slots", []):
                lg.add_input_slot_data(
                    SlotData(
                        NodeId(slot["node_id"]),
                        SlotId(slot["slot_id"]),
                        SlotImage([plane(i) for i in slot["planes"]]),
                    )
                )
            from .ops.embed import EmbeddedSlotDataId

            for entry in meta.get("embedded", []):
                lg.embed_slot_data_with_id(
                    SlotData(
                        NodeId(0),
                        SlotId(entry["slot_id"]),
                        SlotImage([plane(i) for i in entry["planes"]]),
                    ),
                    EmbeddedSlotDataId(entry["id"]),
                )

            for nid_str, state_name in meta["states"].items():
                state = NodeState(state_name)
                # in-flight work is not resumable
                if state in (NodeState.PROCESSING, NodeState.PROCESSING_DIRTY):
                    state = NodeState.DIRTY
                lg._node_state[NodeId(int(nid_str))] = state
    # a freshly restored session starts with no undo history (the restore
    # itself is not a user edit)
    live_graph.clear_history()
    return live_graph
