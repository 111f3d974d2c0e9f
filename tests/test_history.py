"""Edit history (undo/redo) — an extension; the reference has no
undo (`/root/reference/src/live_graph.rs` exposes edits only forward).

Contract under test (live_graph.py `_edit_unit`/`undo`/`redo`):
- one mutating call == one undo unit; one `write()` transaction == one unit
- undo/redo restore topology EXACTLY (serde-structure equality) and pixels
  BIT-exactly, by minimal diff through the normal edit machinery (so only
  affected nodes re-dirty)
- redo history clears on a fresh edit; capacity bounds both stacks;
  `history_capacity = 0` disables journaling
"""

import random

import numpy as np
import pytest

from kanter_core_tpu import (
    MixType,
    Node,
    NodeGraph,
    NodeId,
    NodeType,
    ResizeFilter,
    Side,
    SlotId,
    TextureProcessor,
)
from kanter_core_tpu.live_graph import NodeState


@pytest.fixture
def tp():
    tex_pro = TextureProcessor(200_000_000)
    yield tex_pro
    tex_pro.shutdown_now()


def _read(lg, node_id):
    return TextureProcessor.buffer_rgba(lg, node_id, SlotId(0)).copy()


def _build_chain(lg):
    """noise -> levels -> out, built in ONE write() transaction."""
    with lg.write() as g:
        n = g.add_node(Node(NodeType.Noise(40, 40, 8, 3, 7)))
        lv = g.add_node(Node(NodeType.Levels(0.1, 0.9, 1.4, 0.0, 1.0)))
        o = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(n, lv, SlotId(0), SlotId(0))
        g.connect(lv, o, SlotId(0), SlotId(0))
    return n, lv, o


def test_param_edit_undo_redo_bit_exact(tp):
    lg = tp.new_live_graph()
    n, lv, o = _build_chain(lg)
    assert lg.undo_depth() == 1  # the whole build is one unit
    before = _read(lg, o)
    lg.set_levels(lv, 0.3, 0.7, 0.8, 0.1, 0.9)
    edited = _read(lg, o)
    assert not np.array_equal(before, edited)

    assert lg.undo()
    assert np.array_equal(_read(lg, o), before)
    assert lg.redo()
    assert np.array_equal(_read(lg, o), edited)


def test_build_transaction_is_one_unit(tp):
    lg = tp.new_live_graph()
    _build_chain(lg)
    assert lg.undo_depth() == 1
    assert lg.undo()
    assert lg.node_graph.nodes == [] and lg.node_graph.edges == []
    assert not lg.undo()
    assert lg.redo()
    assert len(lg.node_graph.nodes) == 3 and len(lg.node_graph.edges) == 2


def test_connect_and_remove_edge_undo(tp):
    lg = tp.new_live_graph()
    with lg.write() as g:
        a = g.add_node(Node(NodeType.Value(0.25)))
        b = g.add_node(Node(NodeType.Value(0.5)))
        m = g.add_node(Node(NodeType.Mix(MixType.ADD)))
        o = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(a, m, SlotId(0), SlotId(0))
        g.connect(m, o, SlotId(0), SlotId(0))
    one_input = _read(lg, o)
    lg.connect(b, m, SlotId(0), SlotId(1))
    two_inputs = _read(lg, o)
    assert not np.array_equal(one_input, two_inputs)

    assert lg.undo()  # disconnects b
    assert np.array_equal(_read(lg, o), one_input)
    assert lg.redo()
    assert np.array_equal(_read(lg, o), two_inputs)

    edge = lg.node_graph.edges[-1]
    lg.remove_edge(edge)
    assert np.array_equal(_read(lg, o), one_input)
    assert lg.undo()
    assert np.array_equal(_read(lg, o), two_inputs)


def test_remove_node_undo_restores_pixels_and_name(tp):
    lg = tp.new_live_graph()
    n, lv, o = _build_chain(lg)
    before = _read(lg, o)
    snap = lg.node_graph.to_json()

    lg.remove_node(lv)  # severs the chain
    assert lg.undo()
    assert lg.node_graph.to_json() == snap
    assert np.array_equal(_read(lg, o), before)
    # the restored Output node kept its exact name (no dedup mangling)
    assert lg.node(o).node_type.name() == "out"


def test_undo_is_minimal_diff_keeps_unrelated_branch_clean(tp):
    lg = tp.new_live_graph()
    with lg.write() as g:
        n = g.add_node(Node(NodeType.Noise(32, 32, 8, 2, 1)))
        la = g.add_node(Node(NodeType.Levels(0.0, 1.0, 1.0, 0.0, 1.0)))
        lb = g.add_node(Node(NodeType.Levels(0.0, 1.0, 2.0, 0.0, 1.0)))
        oa = g.add_node(Node(NodeType.OutputGray("a")))
        ob = g.add_node(Node(NodeType.OutputGray("b")))
        g.connect(n, la, SlotId(0), SlotId(0))
        g.connect(n, lb, SlotId(0), SlotId(0))
        g.connect(la, oa, SlotId(0), SlotId(0))
        g.connect(lb, ob, SlotId(0), SlotId(0))
    _read(lg, oa)
    _read(lg, ob)
    lg.set_levels(la, 0.2, 0.8, 1.0, 0.0, 1.0)
    _read(lg, oa)
    _read(lg, ob)
    assert lg.undo()
    # branch B was untouched by the undo diff: still Clean, no recompute
    assert lg.node_state(ob) == NodeState.CLEAN
    assert lg.node_state(oa) != NodeState.CLEAN


def test_redo_cleared_by_new_edit(tp):
    lg = tp.new_live_graph()
    n, lv, o = _build_chain(lg)
    lg.set_levels(lv, 0.3, 0.7, 0.8, 0.1, 0.9)
    assert lg.undo()
    assert lg.redo_depth() == 1
    lg.set_levels(lv, 0.4, 0.6, 1.0, 0.0, 1.0)  # fresh edit
    assert lg.redo_depth() == 0
    assert not lg.redo()


def test_capacity_bound_drops_oldest(tp):
    lg = tp.new_live_graph()
    lg.history_capacity = 4
    n, lv, o = _build_chain(lg)
    for i in range(10):
        lg.set_levels(lv, 0.1 + 0.05 * i, 0.9, 1.0, 0.0, 1.0)
    assert lg.undo_depth() == 4
    undone = 0
    while lg.undo():
        undone += 1
    assert undone == 4
    # the oldest retained pre-state is the one 4 edits back, not the build
    assert len(lg.node_graph.nodes) == 3


def test_capacity_zero_disables_journaling(tp):
    lg = tp.new_live_graph()
    lg.history_capacity = 0
    _build_chain(lg)
    assert lg.undo_depth() == 0
    assert not lg.undo()


def test_node_mut_standalone_is_eager_unit(tp):
    lg = tp.new_live_graph()
    n, lv, o = _build_chain(lg)
    lg.node_mut(lv).resize_filter = ResizeFilter.NEAREST
    assert lg.undo_depth() == 2
    assert lg.undo()
    assert lg.node(lv).resize_filter == ResizeFilter.TRIANGLE


def test_set_node_graph_swap_undo(tp):
    lg = tp.new_live_graph()
    n, lv, o = _build_chain(lg)
    before = _read(lg, o)
    snap = lg.node_graph.to_json()

    other = NodeGraph()
    v = other.add_node(Node(NodeType.Value(0.5)))
    oo = other.add_node(Node(NodeType.OutputGray("swapped")))
    other.connect(v, oo, SlotId(0), SlotId(0))
    lg.set_node_graph(other)
    assert lg.node(oo).node_type.name() == "swapped"

    assert lg.undo()
    assert lg.node_graph.to_json() == snap
    assert np.array_equal(_read(lg, o), before)


def test_rename_collision_ordering(tp):
    """An undo that both renames a surviving output and re-adds a removed
    one must not trip name dedup (in-place updates run before adds)."""
    lg = tp.new_live_graph()
    with lg.write() as g:
        v = g.add_node(Node(NodeType.Value(0.5)))
        o1 = g.add_node(Node(NodeType.OutputGray("bar")))
        o2 = g.add_node(Node(NodeType.OutputGray("other")))
        g.connect(v, o1, SlotId(0), SlotId(0))
        g.connect(v, o2, SlotId(0), SlotId(0))
    snap = lg.node_graph.to_json()
    with lg.write() as g:
        # o1 takes a new name; a NEW node takes o1's old name
        g.rename_output_node(o1, "baz")
        o3 = g.add_node(Node(NodeType.OutputGray("bar")))
        g.connect(v, o3, SlotId(0), SlotId(0))
    assert lg.node(o1).node_type.name() == "baz"
    assert lg.undo()
    assert lg.node_graph.to_json() == snap
    assert lg.node(o1).node_type.name() == "bar"


def test_undo_storm_walks_history_exactly(tp):
    """Random edit storm; every unit's snapshot is recorded, then history is
    walked all the way back and forward comparing serde structures."""
    rng = random.Random(1234)
    lg = tp.new_live_graph()
    snaps = [lg.node_graph.to_json()]  # empty graph
    with lg.write() as g:
        src = g.add_node(Node(NodeType.Noise(24, 24, 6, 2, 3)))
        out = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(src, out, SlotId(0), SlotId(0))
    snaps.append(lg.node_graph.to_json())

    mids = []  # ids of removable middle nodes
    for step in range(40):
        action = rng.random()
        if action < 0.3:
            with lg.write() as g:
                m = g.add_node(Node(NodeType.Levels(rng.random() * 0.4, 0.9, 1.0, 0.0, 1.0)))
                # splice into the chain head
                prev = mids[-1] if mids else src
                g.disconnect_slot(out, Side.INPUT, SlotId(0))
                g.connect(prev, m, SlotId(0), SlotId(0))
                g.connect(m, out, SlotId(0), SlotId(0))
                mids.append(m)
        elif action < 0.5 and mids:
            with lg.write() as g:
                m = mids.pop()
                prev = mids[-1] if mids else src
                g.remove_node(m)
                g.connect(prev, out, SlotId(0), SlotId(0))
        elif action < 0.75 and mids:
            lg.set_levels(rng.choice(mids), rng.random() * 0.4, 0.9,
                          0.5 + rng.random(), 0.0, 1.0)
        else:
            # seed strictly increases so every edit is a real change
            lg.set_noise(src, 24, 24, 6, 2, 100 + step)
        snaps.append(lg.node_graph.to_json())

    # walk back
    for i in range(len(snaps) - 1, 0, -1):
        assert lg.node_graph.to_json() == snaps[i]
        assert lg.undo()
    assert lg.node_graph.to_json() == snaps[0]
    assert not lg.undo()
    # walk forward
    for i in range(1, len(snaps)):
        assert lg.redo()
        assert lg.node_graph.to_json() == snaps[i]
    assert not lg.redo()
    # the final state still evaluates
    assert _read(lg, out).size > 0


def test_nested_graph_eval_keeps_no_history(tp):
    """graph_op's throwaway per-eval LiveGraphs run with journaling off —
    the OUTER graph's history is the user-facing one."""
    lg = tp.new_live_graph()
    inner = NodeGraph()
    white = inner.add_node(Node(NodeType.Value(1.0)))     # inner id 0
    inp = inner.add_node(Node(NodeType.InputGray("in")))  # inner id 1 -> outer in-slot 1
    sub_m = inner.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
    iout = inner.add_node(Node(NodeType.OutputGray("out")))  # inner id 3 -> outer out-slot 3
    inner.connect(white, sub_m, SlotId(0), SlotId(0))
    inner.connect(inp, sub_m, SlotId(0), SlotId(1))
    inner.connect(sub_m, iout, SlotId(0), SlotId(0))
    with lg.write() as g:
        v = g.add_node(Node(NodeType.Value(0.25)))
        sub = g.add_node(Node(NodeType.Graph(inner)))
        o = g.add_node(Node(NodeType.OutputGray("out")))
        g.connect(v, sub, SlotId(0), SlotId(int(inp)))
        g.connect(sub, o, SlotId(int(iout)), SlotId(0))
    px = _read(lg, o)
    assert px.size > 0
    assert lg.undo_depth() == 1  # only the user's build transaction
