"""kanter_core_tpu — an interactive, lazily-evaluated, priority-scheduled
texture node-graph engine on JAX/XLA.

A ground-up JAX/XLA rebuild with the capabilities of the reference
Rust crate `vismut_core` (lukors/kanter_core): DAGs of per-pixel image ops
over f32 channel planes with per-node dirty-state tracking, size
normalization via resize policies, JSON graph persistence, priority-steered
scheduling, and a memory-bounded tiered buffer cache — except the pixel math
runs as fused XLA programs over device-resident `[H, W]` planes instead of
scalar per-pixel loops on CPU threads.

Public surface mirrors the reference's `lib.rs` re-exports.
"""

import os as _os

#: the persistent compile cache when `JAX_COMPILATION_CACHE_DIR` is unset:
#: a fixed directory inside the checkout (listed in .gitignore), so every
#: process of one checkout shares it
DEFAULT_JIT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _configure_persistent_jit_cache() -> None:
    """Persistent XLA compilation cache: interactive sessions recompile
    nothing a previous session already compiled. `JAX_COMPILATION_CACHE_DIR`
    wins when set (JAX reads it itself); otherwise `DEFAULT_JIT_CACHE_DIR`."""
    import jax

    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    _os.makedirs(DEFAULT_JIT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_JIT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)


_configure_persistent_jit_cache()

from .edge import Edge
from .errors import ErrorKind, TexProError
from .geometry import Size
from .ids import NodeId, SlotId
from .live_graph import LiveGraph, NodeState
from .node import (
    AtomicFlag,
    MixType,
    Node,
    PatternKind,
    NodeType,
    NodeTypeKind,
    ResizeFilter,
    ResizePolicy,
    ResizePolicyKind,
    Side,
    Slot,
    SlotType,
)
from .node_graph import NodeGraph
from .ops.embed import EmbeddedSlotData, EmbeddedSlotDataId
from .priority import Priority, PriorityPropagator
from .slot_data import ChannelPixel, SlotData
from .slot_image import SlotImage
from . import autodiff, checkpoint, compiler, graphs, models, native, profiling
from .compiler import CompiledGraph, compile_graph
from .texture_processor import TextureProcessor
from .transient_buffer import AtomicUsize, PlaneBuffer, PlaneBufferQueue, Tier

__version__ = "0.1.0"

__all__ = [
    "AtomicFlag",
    "autodiff",
    "AtomicUsize",
    "ChannelPixel",
    "Edge",
    "EmbeddedSlotData",
    "EmbeddedSlotDataId",
    "ErrorKind",
    "LiveGraph",
    "MixType",
    "Node",
    "NodeGraph",
    "NodeId",
    "NodeState",
    "NodeType",
    "NodeTypeKind",
    "PatternKind",
    "PlaneBuffer",
    "PlaneBufferQueue",
    "Priority",
    "PriorityPropagator",
    "ResizeFilter",
    "ResizePolicy",
    "ResizePolicyKind",
    "Side",
    "Size",
    "Slot",
    "SlotData",
    "SlotId",
    "SlotImage",
    "SlotType",
    "checkpoint",
    "CompiledGraph",
    "compile_graph",
    "compiler",
    "graphs",
    "models",
    "native",
    "profiling",
    "TexProError",
    "TextureProcessor",
    "Tier",
]
