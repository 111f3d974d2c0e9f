"""Every flagship stage is pixel-LIVE (r5 regression guard).

Found in r5: the showcase pipeline's Lighten vignette saturated —
the mix chain netted red − 4·white ≤ 0 everywhere, so
`max(field, ramp) ≡ ramp` and the chain, Pattern, JFA Distance, and
Voronoi stages were computed but mathematically DISCONNECTED from the
output pixels, which made the dryrun's bit-compare vacuous for them.
This guard perturbs ONE runtime knob per stage and asserts the final
pixels change, so the composition can never silently go dead again.
"""

import numpy as np
import pytest

from kanter_core_tpu import SlotId
from kanter_core_tpu.compiler import CompiledGraph
from kanter_core_tpu.graphs import flagship_graph
from kanter_core_tpu.node import NodeTypeKind as K

CANVAS = 64


def _outputs(prog, out):
    return np.stack([np.asarray(p) for p in prog()[(out, SlotId(0))]])


@pytest.fixture(scope="module")
def flagship():
    graph, inputs, out = flagship_graph(CANVAS)
    prog = CompiledGraph(graph, targets=[(out, SlotId(0))])
    rng = np.random.default_rng(0)
    for node in inputs:
        prog.bind_input(node, [rng.random((CANVAS, CANVAS), dtype=np.float32)])
    return graph, inputs, out, prog, _outputs(prog, out)


def _node_of(graph, kind, payload_pred=lambda p: True):
    return next(
        n for n in graph.nodes
        if n.node_type.kind == kind and payload_pred(n.node_type.payload)
    )


def test_chain_value_is_live(flagship):
    graph, inputs, out, prog, base = flagship
    # the logistic chain's v Value (0.96) — its chaos knob
    v_val = _node_of(graph, K.VALUE, lambda p: float(p) != 1.0)
    prog.set_value(v_val.node_id, 0.93)
    try:
        assert not np.array_equal(_outputs(prog, out), base), (
            "the mix chain's Value does not reach the pixels"
        )
    finally:
        prog.set_value(v_val.node_id, float(v_val.node_type.payload))


def test_input_planes_are_live(flagship):
    graph, inputs, out, prog, base = flagship
    key = f"input_{int(inputs[0])}"
    old = prog._bindings[key]
    prog.bind_input(inputs[0], [np.roll(np.asarray(old[0]), 7, axis=0)])
    try:
        assert not np.array_equal(_outputs(prog, out), base), (
            "input planes do not reach the pixels"
        )
    finally:
        prog._bindings[key] = old


@pytest.mark.parametrize(
    "kind,field",
    [
        (K.NOISE, "persistence"),
        # the brick MASK (slot 0, the consumed output) is seed-independent
        # by design (seed only re-hashes the cells-ID output) — mortar is
        # the mask's geometry knob
        (K.PATTERN, "mortar"),
        (K.VORONOI, "jitter"),
        (K.RAMP, "k"),  # angle/center/scale ride packed in the k vector
        (K.DISTANCE, "max_dist"),
    ],
)
def test_each_source_and_distance_is_live(flagship, kind, field):
    """Perturbing each procedural source's runtime argument (and the
    Distance spread) must change the final pixels — these ride as
    program-argument overrides, so perturb via the binding pytree."""
    graph, inputs, out, prog, base = flagship
    node = _node_of(graph, kind)
    nid = int(node.node_id)
    if kind == K.DISTANCE:
        key, sub = f"dist_{nid}", None
    else:
        key = f"{kind.value.lower()}_{nid}"
        sub = field
    old = prog._bindings[key]
    if sub is None:
        prog._bindings[key] = np.float32(float(old) * 0.5)
    else:
        changed = dict(old)
        assert sub in changed, f"binding {key} has no field {sub!r}"
        if field == "k":
            changed[sub] = np.asarray(old[sub], np.float32) * np.float32(0.8)
        else:
            changed[sub] = np.float32(float(old[sub]) * 0.5 + 0.1)
        prog._bindings[key] = changed
    try:
        assert not np.array_equal(_outputs(prog, out), base), (
            f"{kind.value}.{field} does not reach the pixels — a stage "
            "has gone mathematically dead (saturated clamp/min/max?)"
        )
    finally:
        prog._bindings[key] = old
