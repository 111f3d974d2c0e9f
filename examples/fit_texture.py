"""Inverse procedural texturing: recover graph parameters by gradient descent.

A capability the Rust reference structurally cannot offer: a fused
`CompiledGraph` is a pure jittable function of its leaf bindings, so
`jax.grad` flows through the whole texture pipeline. Here a 3-gain RGB
grading graph is fitted to a target image:

    python examples/fit_texture.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np  # noqa: E402

from kanter_core_tpu import (  # noqa: E402
    MixType,
    Node,
    NodeGraph,
    NodeType,
    SlotId,
)
from kanter_core_tpu.autodiff import fit_values  # noqa: E402
from kanter_core_tpu.compiler import CompiledGraph  # noqa: E402


def main():
    # graph: rgba input -> separate -> per-channel gain -> combine -> out
    g = NodeGraph()
    inp = g.add_node(Node(NodeType.InputRgba("in")))
    sep = g.add_node(Node(NodeType.SeparateRgba()))
    comb = g.add_node(Node(NodeType.CombineRgba()))
    out = g.add_node(Node(NodeType.OutputRgba("out")))
    g.connect(inp, sep, SlotId(0), SlotId(0))
    gains = []
    for ch in range(3):
        gain = g.add_node(Node(NodeType.Value(1.0)))
        mix = g.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
        g.connect(sep, mix, SlotId(ch), SlotId(0))
        g.connect(gain, mix, SlotId(0), SlotId(1))
        g.connect(mix, comb, SlotId(0), SlotId(ch))
        gains.append(gain)
    g.connect(sep, comb, SlotId(3), SlotId(3))
    g.connect(comb, out, SlotId(0), SlotId(0))

    prog = CompiledGraph(g, targets=[(out, SlotId(0))])
    rng = np.random.default_rng(0)
    base = rng.random((4, 128, 128), dtype=np.float32)
    prog.bind_input_rgba(list(base))

    # target: the same image graded with secret gains
    secret = (0.8, 0.45, 0.6)
    target = tuple(base[ch] * np.float32(secret[ch]) for ch in range(3)) + (base[3],)

    values, losses = fit_values(
        prog,
        {(out, SlotId(0)): target},
        wrt=gains,
        steps=400,
        learning_rate=0.05,
    )
    fitted = [values[gain] for gain in gains]
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.2e} over {len(losses)} steps")
    print("fitted gains:", [round(v, 4) for v in fitted], "secret:", secret)
    assert all(abs(f - s) < 0.01 for f, s in zip(fitted, secret))
    print("recovered the grading within 1%")


if __name__ == "__main__":
    main()
