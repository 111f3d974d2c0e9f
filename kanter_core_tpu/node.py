"""Node metadata: types, slots, resize policies/filters.

Mirrors `/root/reference/src/node/mod.rs` (Node struct, SlotType/Slot, Side,
ResizePolicy, ResizeFilter) and `/root/reference/src/node/node_type.rs`
(NodeType enum + per-type slot signature tables, `node_type.rs:141-210`) and
`/root/reference/src/node/mix.rs:21-33` (MixType).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import threading
from typing import Any, Optional

from .errors import ErrorKind, TexProError
from .ids import NodeId, SlotId
from .priority import Priority


class AtomicFlag:
    """Boolean flag shared across threads (reference: `Arc<AtomicBool>`)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: bool = False):
        self._value = bool(value)
        self._lock = threading.Lock()

    def store(self, value: bool) -> None:
        with self._lock:
            self._value = bool(value)

    def load(self) -> bool:
        return self._value

    def take(self) -> bool:
        """Atomically read-and-clear; mirrors the commit-time
        `compare_exchange(true, false)` at `/root/reference/src/engine.rs:82-87`."""
        with self._lock:
            value = self._value
            self._value = False
            return value


class Side(enum.Enum):
    INPUT = "Input"
    OUTPUT = "Output"


class SlotType(enum.Enum):
    GRAY = "Gray"
    RGBA = "Rgba"
    GRAY_OR_RGBA = "GrayOrRgba"

    def fits(self, other: "SlotType") -> None:
        """Output-slot-type → input-slot-type compatibility
        (`/root/reference/src/node/mod.rs:210-221`). Raises on mismatch."""
        if self == SlotType.GRAY:
            ok = other in (SlotType.GRAY, SlotType.GRAY_OR_RGBA)
        elif self == SlotType.RGBA:
            ok = other in (SlotType.RGBA, SlotType.GRAY_OR_RGBA)
        else:
            ok = True
        if not ok:
            raise TexProError(ErrorKind.INVALID_SLOT_TYPE)


@dataclasses.dataclass
class Slot:
    name: str
    slot_id: SlotId
    slot_type: SlotType


SlotInput = Slot
SlotOutput = Slot


class MixType(enum.Enum):
    # Reference variants (`/root/reference/src/node/mix.rs:21-27`):
    ADD = "Add"
    SUBTRACT = "Subtract"
    MULTIPLY = "Multiply"
    DIVIDE = "Divide"
    POW = "Pow"
    # Extension blend modes (no reference counterpart; classic
    # compositing modes every texture tool ships — semantics in ops/mix.py).
    # Appended AFTER the reference variants so `list(MixType)[..5]` indexing
    # and existing graph JSON stay stable:
    DARKEN = "Darken"
    LIGHTEN = "Lighten"
    DIFFERENCE = "Difference"
    SCREEN = "Screen"
    OVERLAY = "Overlay"

    @staticmethod
    def default() -> "MixType":
        return MixType.ADD

    @staticmethod
    def reference_types() -> tuple:
        """The five variants the reference implements (goldens cover these);
        the rest are extension blend modes."""
        return (MixType.ADD, MixType.SUBTRACT, MixType.MULTIPLY,
                MixType.DIVIDE, MixType.POW)


class PatternKind(enum.Enum):
    """Pattern node lattice kinds (extension — see ops/pattern.py). The
    kind picks one of three traced formulas, so it SHAPES the trace like
    Noise's octave count; every other Pattern parameter is a program
    argument."""

    CHECKER = "Checker"
    BRICK = "Brick"
    STRIPE = "Stripe"

    @staticmethod
    def default() -> "PatternKind":
        return PatternKind.CHECKER


class ResizeFilter(enum.Enum):
    NEAREST = "Nearest"
    TRIANGLE = "Triangle"
    CATMULL_ROM = "CatmullRom"
    GAUSSIAN = "Gaussian"
    LANCZOS3 = "Lanczos3"

    @staticmethod
    def default() -> "ResizeFilter":
        return ResizeFilter.TRIANGLE


class ResizePolicyKind(enum.Enum):
    MOST_PIXELS = "MostPixels"
    LEAST_PIXELS = "LeastPixels"
    LARGEST_AXES = "LargestAxes"
    SMALLEST_AXES = "SmallestAxes"
    SPECIFIC_SLOT = "SpecificSlot"
    SPECIFIC_SIZE = "SpecificSize"


@dataclasses.dataclass(frozen=True)
class ResizePolicy:
    """Input-size normalization policy (`/root/reference/src/node/mod.rs:33-47`)."""

    kind: ResizePolicyKind
    payload: Any = None  # SlotId for SPECIFIC_SLOT, Size for SPECIFIC_SIZE

    @staticmethod
    def MostPixels() -> "ResizePolicy":
        return ResizePolicy(ResizePolicyKind.MOST_PIXELS)

    @staticmethod
    def LeastPixels() -> "ResizePolicy":
        return ResizePolicy(ResizePolicyKind.LEAST_PIXELS)

    @staticmethod
    def LargestAxes() -> "ResizePolicy":
        return ResizePolicy(ResizePolicyKind.LARGEST_AXES)

    @staticmethod
    def SmallestAxes() -> "ResizePolicy":
        return ResizePolicy(ResizePolicyKind.SMALLEST_AXES)

    @staticmethod
    def SpecificSlot(slot_id) -> "ResizePolicy":
        return ResizePolicy(ResizePolicyKind.SPECIFIC_SLOT, SlotId(slot_id))

    @staticmethod
    def SpecificSize(size) -> "ResizePolicy":
        return ResizePolicy(ResizePolicyKind.SPECIFIC_SIZE, size)

    @staticmethod
    def default() -> "ResizePolicy":
        return ResizePolicy.MostPixels()

    def to_json(self):
        if self.kind == ResizePolicyKind.SPECIFIC_SLOT:
            return {"SpecificSlot": int(self.payload)}
        if self.kind == ResizePolicyKind.SPECIFIC_SIZE:
            return {"SpecificSize": {"width": self.payload.width, "height": self.payload.height}}
        return self.kind.value

    @staticmethod
    def from_json(data) -> "ResizePolicy":
        from .slot_data import Size

        if isinstance(data, str):
            return ResizePolicy(ResizePolicyKind(data))
        if "SpecificSlot" in data:
            return ResizePolicy.SpecificSlot(SlotId(data["SpecificSlot"]))
        if "SpecificSize" in data:
            size = data["SpecificSize"]
            return ResizePolicy.SpecificSize(Size(size["width"], size["height"]))
        raise TexProError(ErrorKind.GENERIC, f"bad resize policy: {data!r}")


class NodeTypeKind(enum.Enum):
    INPUT_GRAY = "InputGray"
    INPUT_RGBA = "InputRgba"
    OUTPUT_GRAY = "OutputGray"
    OUTPUT_RGBA = "OutputRgba"
    GRAPH = "Graph"
    IMAGE = "Image"
    EMBED = "Embed"
    WRITE = "Write"
    VALUE = "Value"
    MIX = "Mix"
    HEIGHT_TO_NORMAL = "HeightToNormal"
    SEPARATE_RGBA = "SeparateRgba"
    COMBINE_RGBA = "CombineRgba"
    BLUR = "Blur"  # extension: no reference counterpart
    LEVELS = "Levels"  # extension: no reference counterpart
    NOISE = "Noise"  # extension: no reference counterpart
    GRADIENT_MAP = "GradientMap"  # extension: no reference counterpart
    TRANSFORM = "Transform"  # extension: no reference counterpart
    WARP = "Warp"  # extension: no reference counterpart
    PATTERN = "Pattern"  # extension: no reference counterpart
    CURVATURE = "Curvature"  # extension: no reference counterpart
    HSV = "Hsv"  # extension: no reference counterpart
    AMBIENT_OCCLUSION = "AmbientOcclusion"  # extension: no reference counterpart
    DISTANCE = "Distance"  # extension: no reference counterpart
    VORONOI = "Voronoi"  # extension: no reference counterpart
    RAMP = "Ramp"  # extension: no reference counterpart


class NodeType:
    """Tagged union of node kinds (`/root/reference/src/node/node_type.rs:14-28`).

    Equality compares the discriminant only, matching the reference's
    `mem::discriminant` PartialEq (`node_type.rs:50-54`).
    """

    __slots__ = ("kind", "payload")

    def __init__(self, kind: NodeTypeKind, payload: Any = None):
        self.kind = kind
        self.payload = payload

    # --- constructors mirroring the enum variants ---
    @staticmethod
    def InputGray(name: str) -> "NodeType":
        return NodeType(NodeTypeKind.INPUT_GRAY, str(name))

    @staticmethod
    def InputRgba(name: str) -> "NodeType":
        return NodeType(NodeTypeKind.INPUT_RGBA, str(name))

    @staticmethod
    def OutputGray(name: str) -> "NodeType":
        return NodeType(NodeTypeKind.OUTPUT_GRAY, str(name))

    @staticmethod
    def OutputRgba(name: str) -> "NodeType":
        return NodeType(NodeTypeKind.OUTPUT_RGBA, str(name))

    @staticmethod
    def Graph(node_graph) -> "NodeType":
        return NodeType(NodeTypeKind.GRAPH, node_graph)

    @staticmethod
    def Image(path) -> "NodeType":
        return NodeType(NodeTypeKind.IMAGE, str(path))

    @staticmethod
    def Embed(embedded_slot_data_id) -> "NodeType":
        return NodeType(NodeTypeKind.EMBED, embedded_slot_data_id)

    @staticmethod
    def Write(path) -> "NodeType":
        return NodeType(NodeTypeKind.WRITE, str(path))

    @staticmethod
    def Value(value: float) -> "NodeType":
        return NodeType(NodeTypeKind.VALUE, float(value))

    @staticmethod
    def Mix(mix_type: MixType = None) -> "NodeType":
        return NodeType(NodeTypeKind.MIX, mix_type or MixType.default())

    @staticmethod
    def HeightToNormal() -> "NodeType":
        return NodeType(NodeTypeKind.HEIGHT_TO_NORMAL)

    @staticmethod
    def Blur(sigma: float = 1.0) -> "NodeType":
        """Separable Gaussian blur with toroidal wrap (extension node —
        the reference has no blur; sigma is in pixels of the input).
        `sigma` must be in (0, 256]: the tap table and the jnp roll
        chain are O(sigma) HOST/trace structures, so an absurd payload
        (e.g. 1e9) would hang tap baking or compile."""
        sigma = float(sigma)
        if not (0.0 < sigma <= 256.0):
            raise TexProError(
                ErrorKind.GENERIC, "Blur needs sigma in (0, 256]"
            )
        return NodeType(NodeTypeKind.BLUR, sigma)

    @staticmethod
    def Levels(in_lo: float = 0.0, in_hi: float = 1.0, gamma: float = 1.0,
               out_lo: float = 0.0, out_hi: float = 1.0) -> "NodeType":
        """Levels remap (extension node): per plane,
        `out = out_lo + (out_hi−out_lo) · clip((x−in_lo)/(in_hi−in_lo), 0, 1)^gamma`.
        The five parameters are PROGRAM ARGUMENTS in every traced consumer
        (like Value constants), so slider drags re-run cached executables.
        IEEE propagation on a degenerate span (in_hi == in_lo): the divide
        yields ±inf/NaN, the clip resolves ±inf to 1/0, NaN stays NaN."""
        return NodeType(
            NodeTypeKind.LEVELS,
            (float(in_lo), float(in_hi), float(gamma), float(out_lo), float(out_hi)),
        )

    @staticmethod
    def Noise(width: int, height: int, cells: int = 8, octaves: int = 4,
              seed: int = 0, persistence: float = 0.5) -> "NodeType":
        """Seamlessly-tiling FBM value-noise source (extension node; see
        ops/noise.py). `width`×`height` Gray output; `cells` lattice cells
        per axis at octave 0 (doubling per octave, wrapping toroidally);
        `seed`/`persistence`/`cells` are PROGRAM ARGUMENTS in every traced
        consumer, so seed cycling and slider drags re-run cached
        executables; `octaves` and the size shape the trace."""
        width = NodeType._axis(width, "Noise width")
        height = NodeType._axis(height, "Noise height")
        cells, octaves = NodeType._axis(cells, "Noise cells"), int(octaves)
        if octaves < 1:
            raise TexProError(
                ErrorKind.GENERIC, "Noise needs octaves >= 1"
            )
        if octaves > 24:
            # octaves shape the TRACE (one lattice pass each) and double
            # the cell frequency per octave — past 2^24 cells no canvas
            # this framework serves has sub-cell pixels, and an absurd
            # payload would hang the trace (the r4 payload-hazard class)
            raise TexProError(
                ErrorKind.GENERIC, "Noise needs octaves <= 24"
            )
        if cells << (octaves - 1) > (1 << 30):
            # the top octave's wrap period rides as i32 in the bindings;
            # past 2^30 it overflows (found by the r5 payload fuzz)
            raise TexProError(
                ErrorKind.GENERIC,
                "Noise needs cells * 2^(octaves-1) <= 2^30",
            )
        return NodeType(
            NodeTypeKind.NOISE,
            (width, height, cells, octaves,
             int(seed) & 0xFFFFFFFF, float(persistence)),
        )

    @staticmethod
    def Pattern(width: int, height: int, pattern="Checker", cells_x: int = 8,
                cells_y: int = 8, mortar: float = 0.0, bevel: float = 0.0,
                seed: int = 0) -> "NodeType":
        """Procedural tiling-mask source (extension node; see
        ops/pattern.py). Two Gray outputs: `mask` (slot 0 — checker/brick/
        stripe field with a mortar/bevel groove ramp) and `cells` (slot 1 —
        a per-cell random ID in [0,1) for per-tile variation).
        `cells_x`/`cells_y`/`mortar`/`bevel`/`seed` are PROGRAM ARGUMENTS
        in every traced consumer (cell-count and groove drags re-run cached
        executables); the size and the `pattern` kind shape the trace."""
        pattern = PatternKind(pattern).value  # accept enum or serde string
        width = NodeType._axis(width, "Pattern width")
        height = NodeType._axis(height, "Pattern height")
        cells_x = NodeType._axis(cells_x, "Pattern cells_x")
        cells_y = NodeType._axis(cells_y, "Pattern cells_y")
        if not (float(mortar) >= 0.0 and float(bevel) >= 0.0):
            raise TexProError(
                ErrorKind.GENERIC, "Pattern needs mortar/bevel >= 0"
            )
        return NodeType(
            NodeTypeKind.PATTERN,
            (width, height, pattern, cells_x, cells_y,
             float(mortar), float(bevel), int(seed) & 0xFFFFFFFF),
        )

    @staticmethod
    def Voronoi(width: int, height: int, cells_x: int = 8, cells_y: int = 8,
                jitter: float = 1.0, seed: int = 0) -> "NodeType":
        """Seamlessly-tiling cellular-noise source (extension node; see
        ops/voronoi.py). Three Gray outputs: `distance` (slot 0 — F1
        nearest-point distance in cell units, clipped to [0,1]), `borders`
        (slot 1 — F2−F1 cell-boundary ridge field), and `cells` (slot 2 —
        the nearest point's random ID in [0,1) for per-cell variation).
        `cells_x`/`cells_y`/`jitter`/`seed` are PROGRAM ARGUMENTS in every
        traced consumer (cell-count drags, jitter sliders, and seed cycling
        re-run cached executables); only the size shapes the trace.
        `jitter` is bounded to [0, 1] so a feature point stays inside its
        own cell and the 5×5 neighbourhood search is exact for F1, F2,
        and the ID (ops/voronoi.py proves the window bound; a 3×3 window
        is only exact up to jitter ≈ 0.5)."""
        width = NodeType._axis(width, "Voronoi width")
        height = NodeType._axis(height, "Voronoi height")
        cells_x = NodeType._axis(cells_x, "Voronoi cells_x")
        cells_y = NodeType._axis(cells_y, "Voronoi cells_y")
        if not (0.0 <= float(jitter) <= 1.0):
            raise TexProError(
                ErrorKind.GENERIC, "Voronoi needs jitter in [0, 1]"
            )
        return NodeType(
            NodeTypeKind.VORONOI,
            (width, height, cells_x, cells_y, float(jitter),
             int(seed) & 0xFFFFFFFF),
        )

    @staticmethod
    def Ramp(width: int, height: int, kind: str = "Linear",
             angle: float = 0.0, cx: float = 0.5, cy: float = 0.5,
             scale: float = 1.0) -> "NodeType":
        """Procedural gradient source (extension node; see ops/ramp.py):
        one Gray plane over normalized canvas coordinates — `Linear`
        (0.5 at the center, rising along `angle` degrees), `Radial`
        (Euclidean distance fade from `(cx, cy)`), or `Box` (Chebyshev
        square fade). `angle`/`cx`/`cy`/`scale` are PROGRAM ARGUMENTS in
        every traced consumer (drags re-run cached executables); only the
        size and the KIND (three distinct formulas) shape the trace."""
        width = NodeType._axis(width, "Ramp width")
        height = NodeType._axis(height, "Ramp height")
        if kind not in ("Linear", "Radial", "Box"):
            raise TexProError(
                ErrorKind.GENERIC, f"unknown ramp kind {kind!r}"
            )
        import math

        if not all(math.isfinite(float(v)) for v in (angle, cx, cy, scale)):
            raise TexProError(
                ErrorKind.GENERIC, "Ramp needs finite angle/center/scale"
            )
        return NodeType(
            NodeTypeKind.RAMP,
            (width, height, str(kind), float(angle), float(cx), float(cy),
             float(scale)),
        )

    @staticmethod
    def Curvature(strength: float = 4.0) -> "NodeType":
        """Mean-curvature mask of a gray heightmap (extension node; see
        ops/curvature.py): `clip(0.5 + strength·laplacian, 0, 1)` with
        toroidal wrap — convex edges brighten, crevices darken. `strength`
        is a PROGRAM ARGUMENT in every traced consumer (slider drags
        re-run cached executables)."""
        return NodeType(NodeTypeKind.CURVATURE, float(strength))

    @staticmethod
    def Distance(max_dist: float = 16.0) -> "NodeType":
        """Normalized toroidal distance fade from a gray seed mask
        (extension node; see ops/distance.py): pixels where `mask > 0.5`
        seed a jump-flooded distance field, output is
        `clip(1 − d/max_dist, 0, 1)`. `max_dist` (pixels) is a PROGRAM
        ARGUMENT in every traced consumer (spread drags re-run cached
        executables)."""
        if not (float(max_dist) > 0.0):
            raise TexProError(
                ErrorKind.GENERIC, "Distance needs max_dist > 0"
            )
        return NodeType(NodeTypeKind.DISTANCE, float(max_dist))

    @staticmethod
    def AmbientOcclusion(strength: float = 2.0,
                         radius: float = 2.0) -> "NodeType":
        """Multi-scale heightmap AO mask (extension node; see
        ops/ambient_occlusion.py): pits and crevices darken via blurred
        height at sigmas radius·(1,2,4) with toroidal wrap. `strength` is
        a PROGRAM ARGUMENT in every traced consumer (slider drags re-run
        cached executables); `radius` bakes the Gaussian taps into the
        trace like Blur's sigma (a radius edit refingerprints)."""
        if not (0.0 < float(radius) <= 64.0):
            # radius bakes sigmas radius·(1,2,4) into Gaussian tap tables
            # — the Blur O(sigma) host/trace bound, divided by the
            # largest scale factor (the r4 payload-hazard class)
            raise TexProError(
                ErrorKind.GENERIC, "AmbientOcclusion needs radius in (0, 64]"
            )
        return NodeType(
            NodeTypeKind.AMBIENT_OCCLUSION, (float(strength), float(radius))
        )

    @staticmethod
    def Hsv(hue: float = 0.0, saturation: float = 1.0,
            value: float = 1.0) -> "NodeType":
        """Hue-rotate / saturation-scale / value-scale color adjust
        (extension node; see ops/hsv.py): `hue` in degrees (any value,
        wrapped), `saturation`/`value` multiplicative with clip to [0,1].
        Gray inputs get the value scale only. All three parameters are one
        PROGRAM ARGUMENT in every traced consumer (slider drags re-run
        cached executables)."""
        return NodeType(
            NodeTypeKind.HSV, (float(hue), float(saturation), float(value))
        )

    @staticmethod
    def GradientMap(stops) -> "NodeType":
        """Colorize ramp (extension node; see ops/gradient.py): gray →
        RGBA through ≥2 color stops `(position, r, g, b, a)`, lerped per
        segment. Stops are sorted by position here; their VALUES are
        program arguments in every traced consumer (stop drags re-run
        cached executables), only the stop COUNT shapes the trace."""
        stops = tuple(
            (float(s[0]), float(s[1]), float(s[2]), float(s[3]), float(s[4]))
            for s in stops
        )
        if len(stops) < 2:
            raise TexProError(
                ErrorKind.GENERIC, "GradientMap needs at least 2 stops"
            )
        if len(stops) > 256:
            # the stop COUNT shapes the trace (one select per stop in
            # every traced consumer) — an absurd list is the Blur(1e9)
            # trace-hazard class (r5 review finding; serde truncates)
            raise TexProError(
                ErrorKind.GENERIC, "GradientMap needs <= 256 stops"
            )
        return NodeType(
            NodeTypeKind.GRADIENT_MAP, tuple(sorted(stops, key=lambda s: s[0]))
        )

    @staticmethod
    def Transform(offset_x: float = 0.0, offset_y: float = 0.0,
                  rotation: float = 0.0, scale_x: float = 1.0,
                  scale_y: float = 1.0) -> "NodeType":
        """Affine placement (extension node; see ops/transform.py): rotate
        by `rotation` degrees and scale around the canvas center, then
        translate by `(offset_x, offset_y)` pixels; samples bilinearly with
        toroidal wrap. All five parameters are program arguments in every
        traced consumer (drags re-run cached executables)."""
        return NodeType(
            NodeTypeKind.TRANSFORM,
            (float(offset_x), float(offset_y), float(rotation),
             float(scale_x), float(scale_y)),
        )

    @staticmethod
    def Warp(angle: float = 0.0, intensity: float = 16.0) -> "NodeType":
        """Directional displacement by a gray strength map (extension node;
        see ops/warp.py): sample the input at `intensity·(cos θ, sin θ)·
        (m−0.5)` pixels away, bilinear with toroidal wrap. Both parameters
        are one program argument in every traced consumer (drags re-run
        cached executables); a dangling strength input is a pass-through
        alias."""
        return NodeType(NodeTypeKind.WARP, (float(angle), float(intensity)))

    @staticmethod
    def SeparateRgba() -> "NodeType":
        return NodeType(NodeTypeKind.SEPARATE_RGBA)

    @staticmethod
    def CombineRgba() -> "NodeType":
        return NodeType(NodeTypeKind.COMBINE_RGBA)

    # --- predicates / accessors (`node_type.rs:56-95`) ---
    def is_input(self) -> bool:
        return self.kind in (NodeTypeKind.INPUT_GRAY, NodeTypeKind.INPUT_RGBA)

    def is_output(self) -> bool:
        return self.kind in (NodeTypeKind.OUTPUT_GRAY, NodeTypeKind.OUTPUT_RGBA)

    def name(self) -> Optional[str]:
        if self.is_input() or self.is_output():
            return self.payload
        return None

    def set_name(self, name: str) -> None:
        if not (self.is_input() or self.is_output()):
            raise TexProError(ErrorKind.INVALID_NODE_TYPE)
        self.payload = name

    def to_slot_type(self) -> Optional[SlotType]:
        if self.kind in (NodeTypeKind.INPUT_GRAY, NodeTypeKind.OUTPUT_GRAY):
            return SlotType.GRAY
        if self.kind in (NodeTypeKind.INPUT_RGBA, NodeTypeKind.OUTPUT_RGBA):
            return SlotType.RGBA
        return None

    def __eq__(self, other):
        if isinstance(other, NodeType):
            return self.kind == other.kind
        return NotImplemented

    def __hash__(self):
        return hash(self.kind)

    def __repr__(self):
        if self.payload is None:
            return f"NodeType.{self.kind.value}"
        return f"NodeType.{self.kind.value}({self.payload!r})"

    def clone(self) -> "NodeType":
        payload = self.payload
        if self.kind == NodeTypeKind.GRAPH and payload is not None:
            payload = payload.clone()
        elif self.kind == NodeTypeKind.LEVELS and payload is not None:
            import numpy as _np

            if isinstance(payload, (list, _np.ndarray)):
                payload = payload.copy()  # mutable params, type-preserving
        return NodeType(self.kind, payload)

    def to_json(self):
        k = self.kind
        if k == NodeTypeKind.HEIGHT_TO_NORMAL or k in (
            NodeTypeKind.SEPARATE_RGBA,
            NodeTypeKind.COMBINE_RGBA,
        ):
            return k.value  # serde unit variants serialize as bare strings
        if k == NodeTypeKind.GRAPH:
            return {"Graph": self.payload.to_json()}
        if k == NodeTypeKind.MIX:
            return {"Mix": self.payload.value}
        if k == NodeTypeKind.EMBED:
            return {"Embed": int(self.payload)}
        if k == NodeTypeKind.VALUE:
            return {"Value": self.payload}
        if k == NodeTypeKind.BLUR:
            return {"Blur": self.payload}
        if k == NodeTypeKind.CURVATURE:
            return {"Curvature": self.payload}
        if k == NodeTypeKind.DISTANCE:
            return {"Distance": self.payload}
        if k == NodeTypeKind.HSV:
            p = self.payload
            return {"Hsv": {"hue": p[0], "saturation": p[1], "value": p[2]}}
        if k == NodeTypeKind.AMBIENT_OCCLUSION:
            p = self.payload
            return {"AmbientOcclusion": {"strength": p[0], "radius": p[1]}}
        if k == NodeTypeKind.LEVELS:
            p = self.payload
            return {"Levels": {"in_lo": p[0], "in_hi": p[1], "gamma": p[2],
                               "out_lo": p[3], "out_hi": p[4]}}
        if k == NodeTypeKind.NOISE:
            p = self.payload
            return {"Noise": {"width": p[0], "height": p[1], "cells": p[2],
                              "octaves": p[3], "seed": p[4],
                              "persistence": p[5]}}
        if k == NodeTypeKind.PATTERN:
            p = self.payload
            return {"Pattern": {"width": p[0], "height": p[1], "pattern": p[2],
                                "cells_x": p[3], "cells_y": p[4],
                                "mortar": p[5], "bevel": p[6], "seed": p[7]}}
        if k == NodeTypeKind.VORONOI:
            p = self.payload
            return {"Voronoi": {"width": p[0], "height": p[1],
                                "cells_x": p[2], "cells_y": p[3],
                                "jitter": p[4], "seed": p[5]}}
        if k == NodeTypeKind.RAMP:
            p = self.payload
            return {"Ramp": {"width": p[0], "height": p[1], "kind": p[2],
                             "angle": p[3], "cx": p[4], "cy": p[5],
                             "scale": p[6]}}
        if k == NodeTypeKind.GRADIENT_MAP:
            return {"GradientMap": {"stops": [list(s) for s in self.payload]}}
        if k == NodeTypeKind.TRANSFORM:
            p = self.payload
            return {"Transform": {"offset_x": p[0], "offset_y": p[1],
                                  "rotation": p[2], "scale_x": p[3],
                                  "scale_y": p[4]}}
        if k == NodeTypeKind.WARP:
            p = self.payload
            return {"Warp": {"angle": p[0], "intensity": p[1]}}
        # newtype string payloads: InputGray/InputRgba/OutputGray/OutputRgba/Image/Write
        return {k.value: self.payload}

    @staticmethod
    def _axis(value, what: str) -> int:
        """Canvas-axis / lattice-count validation for procedural sources:
        their bindings allocate O(value) HOST index vectors (`np.arange`),
        so an absurd payload (2^40 found by the r5 payload fuzz) would
        allocate terabytes or hang the host — the r4 payload-hazard class
        (Blur sigma / AO radius / Noise octaves, commit 8fbe499). 65536
        is beyond the packed-JFA canvas bound and any canvas this
        framework serves."""
        value = int(value)
        if not (1 <= value <= 65536):
            raise TexProError(
                ErrorKind.GENERIC, f"{what} must be in [1, 65536]"
            )
        return value

    @staticmethod
    def _serde_axis(value) -> int:
        """Serde leniency for `_axis`-bounded fields: clamp into
        [1, 65536] instead of refusing the load (ADVICE r4 convention)."""
        try:
            v = int(value)
        except (TypeError, ValueError):
            return 1
        return min(max(v, 1), 65536)

    @staticmethod
    def _serde_clamp(value, lo: float, hi: float, default: float,
                     lo_open: bool = False) -> float:
        """Serde leniency (ADVICE r4): payload caps added after graphs were
        saved (Blur sigma, AO radius, Noise octaves — host-hang guards)
        must not make previously-saved files unloadable. On the load path
        an out-of-range or non-finite value CLAMPS into the constructor's
        accepted range; the hard TexProError stays on programmatic
        construction. FIDELITY RULE (r5 review): `lo`/`hi` must be the
        constructor's TRUE bounds — any value the constructor accepts
        passes through bit-unchanged, so save/load never silently rewrites
        a valid payload. `lo_open` marks an exclusive lower bound (Blur's
        (0, 256]): at-or-below it there is no nearest valid value, so the
        default is used."""
        import math

        try:
            v = float(value)
        except (TypeError, ValueError):
            return default
        if not math.isfinite(v):
            return default
        if lo_open and v <= lo:
            return default
        return min(max(v, lo), hi)

    @staticmethod
    def _serde_seed(value) -> int:
        """Serde leniency for seed fields: wrap to u32 like the
        constructors; a non-numeric seed in a saved file falls back to 0
        instead of refusing the whole graph (r5 review — every sibling
        field in the same payload clamps, so the file must still open)."""
        try:
            return int(value) & 0xFFFFFFFF
        except (TypeError, ValueError):
            return 0

    @staticmethod
    def from_json(data) -> "NodeType":
        from .node_graph import NodeGraph

        if isinstance(data, str):
            return NodeType(NodeTypeKind(data))
        (variant, payload), = data.items()
        kind = NodeTypeKind(variant)
        if kind == NodeTypeKind.GRAPH:
            return NodeType(kind, NodeGraph.from_json(payload))
        if kind == NodeTypeKind.MIX:
            return NodeType(kind, MixType(payload))
        if kind == NodeTypeKind.EMBED:
            from .ops.embed import EmbeddedSlotDataId

            return NodeType(kind, EmbeddedSlotDataId(payload))
        if kind == NodeTypeKind.BLUR:
            # the constructor's (0, 256] cap guards host tap baking; a
            # saved Blur(300) loads as Blur(256) rather than failing, and
            # any in-range sigma (incl. 1e-9) round-trips bit-unchanged
            return NodeType.Blur(
                NodeType._serde_clamp(payload, 0.0, 256.0, 1.0, lo_open=True)
            )
        if kind in (NodeTypeKind.VALUE, NodeTypeKind.CURVATURE,
                    NodeTypeKind.DISTANCE):
            return NodeType(kind, float(payload))
        if kind == NodeTypeKind.LEVELS:
            return NodeType.Levels(
                payload["in_lo"], payload["in_hi"], payload["gamma"],
                payload["out_lo"], payload["out_hi"],
            )
        if kind == NodeTypeKind.NOISE:
            octaves = int(NodeType._serde_clamp(payload["octaves"], 1, 24, 4))
            cells = NodeType._serde_axis(payload["cells"])
            # keep the top octave's i32 wrap period in range (the
            # constructor's cells·2^(octaves−1) ≤ 2^30 bound)
            while cells > 1 and cells << (octaves - 1) > (1 << 30):
                cells //= 2
            return NodeType.Noise(
                NodeType._serde_axis(payload["width"]),
                NodeType._serde_axis(payload["height"]),
                cells, octaves,
                NodeType._serde_seed(payload["seed"]), payload["persistence"],
            )
        _inf = float("inf")
        if kind == NodeTypeKind.PATTERN:
            return NodeType.Pattern(
                NodeType._serde_axis(payload["width"]),
                NodeType._serde_axis(payload["height"]),
                payload["pattern"],
                NodeType._serde_axis(payload["cells_x"]),
                NodeType._serde_axis(payload["cells_y"]),
                # constructor accepts any finite >= 0: clamp only
                # negatives/non-finite so valid payloads round-trip
                NodeType._serde_clamp(payload["mortar"], 0.0, _inf, 0.0),
                NodeType._serde_clamp(payload["bevel"], 0.0, _inf, 0.0),
                NodeType._serde_seed(payload["seed"]),
            )
        if kind == NodeTypeKind.VORONOI:
            return NodeType.Voronoi(
                NodeType._serde_axis(payload["width"]),
                NodeType._serde_axis(payload["height"]),
                NodeType._serde_axis(payload["cells_x"]),
                NodeType._serde_axis(payload["cells_y"]),
                NodeType._serde_clamp(payload["jitter"], 0.0, 1.0, 1.0),
                NodeType._serde_seed(payload["seed"]),
            )
        if kind == NodeTypeKind.RAMP:
            # constructor requires FINITE only — pass finite values
            # through bit-unchanged, default only on non-finite
            return NodeType.Ramp(
                NodeType._serde_axis(payload["width"]),
                NodeType._serde_axis(payload["height"]),
                payload["kind"],
                NodeType._serde_clamp(payload["angle"], -_inf, _inf, 0.0),
                NodeType._serde_clamp(payload["cx"], -_inf, _inf, 0.5),
                NodeType._serde_clamp(payload["cy"], -_inf, _inf, 0.5),
                NodeType._serde_clamp(payload["scale"], -_inf, _inf, 1.0),
            )
        if kind == NodeTypeKind.GRADIENT_MAP:
            # stop COUNT shapes the trace: truncate absurd saved lists to
            # the constructor's 256 cap instead of refusing the load
            return NodeType.GradientMap(payload["stops"][:256])
        if kind == NodeTypeKind.TRANSFORM:
            return NodeType.Transform(
                payload["offset_x"], payload["offset_y"], payload["rotation"],
                payload["scale_x"], payload["scale_y"],
            )
        if kind == NodeTypeKind.WARP:
            return NodeType.Warp(payload["angle"], payload["intensity"])
        if kind == NodeTypeKind.HSV:
            return NodeType.Hsv(
                payload["hue"], payload["saturation"], payload["value"]
            )
        if kind == NodeTypeKind.AMBIENT_OCCLUSION:
            return NodeType.AmbientOcclusion(
                payload["strength"],
                NodeType._serde_clamp(
                    payload["radius"], 0.0, 64.0, 2.0, lo_open=True
                ),
            )
        return NodeType(kind, payload)


class Node:
    """A graph node (`/root/reference/src/node/mod.rs:113-161`).

    `priority` and `cancel` are shared handles (reference: `Arc<Priority>` /
    `Arc<AtomicBool>`): clones of a Node share them, and they are skipped by
    serialization (`node/mod.rs:119-122`).
    """

    __slots__ = ("node_id", "node_type", "_resize_policy", "_resize_filter", "priority", "cancel")

    def __init__(self, node_type: NodeType, node_id: NodeId = NodeId(0)):
        self.node_id = NodeId(node_id)
        self.node_type = node_type
        self._resize_policy = ResizePolicy.default()
        self._resize_filter = ResizeFilter.default()
        self.priority = Priority()
        self.cancel = AtomicFlag(False)

    @staticmethod
    def with_id(node_type: NodeType, node_id: NodeId) -> "Node":
        return Node(node_type, node_id)

    # resize policy/filter are plain attributes in the reference; the builder
    # methods share their names, so expose them via properties + builders.
    @property
    def resize_policy(self) -> ResizePolicy:
        return self._resize_policy

    @resize_policy.setter
    def resize_policy(self, value: ResizePolicy) -> None:
        self._resize_policy = value

    @property
    def resize_filter(self) -> ResizeFilter:
        return self._resize_filter

    @resize_filter.setter
    def resize_filter(self, value: ResizeFilter) -> None:
        self._resize_filter = value

    def with_resize_policy(self, resize_policy: ResizePolicy) -> "Node":
        self._resize_policy = resize_policy
        return self

    def with_resize_filter(self, resize_filter: ResizeFilter) -> "Node":
        self._resize_filter = resize_filter
        return self

    def clone(self) -> "Node":
        """Clone sharing `priority`/`cancel` handles but owning its
        `node_type` (reference `Node: Clone`: the enum clones by VALUE —
        Graph payloads deep-copy — while the atomics' Arc handles are
        shared). A shallow copy here let `node().node_type.set_name(...)`
        rename the REAL node behind the dirty tracker's back, and let a
        concurrent rename / nested-graph edit mutate an engine dispatch's
        cloned snapshot mid-flight."""
        node = copy.copy(self)
        node.node_type = self.node_type.clone()
        return node

    def deep_clone_type(self) -> "Node":
        return self.clone()  # kept for callers; clone() now owns node_type

    # --- slot signature tables (`node_type.rs:141-210`) ---
    def input_slots(self) -> list[Slot]:
        k = self.node_type.kind
        K = NodeTypeKind
        if k in (K.INPUT_GRAY, K.INPUT_RGBA, K.IMAGE, K.EMBED, K.VALUE,
                 K.NOISE, K.PATTERN, K.VORONOI, K.RAMP):
            return []
        if k == K.OUTPUT_GRAY:
            return [Slot("input", SlotId(0), SlotType.GRAY)]
        if k == K.OUTPUT_RGBA:
            return [Slot("input", SlotId(0), SlotType.RGBA)]
        if k == K.GRAPH:
            return self.node_type.payload.input_slots()
        if k == K.WRITE:
            # The reference leaves Write's slot tables `unimplemented!()`
            # (`node_type.rs:154,190`), making the node unusable; here it
            # accepts one input of either type so it actually works.
            return [Slot("input", SlotId(0), SlotType.GRAY_OR_RGBA)]
        if k == K.MIX:
            return [
                Slot("left", SlotId(0), SlotType.GRAY_OR_RGBA),
                Slot("right", SlotId(1), SlotType.GRAY_OR_RGBA),
            ]
        if k in (K.HEIGHT_TO_NORMAL, K.GRADIENT_MAP, K.CURVATURE,
                 K.AMBIENT_OCCLUSION, K.DISTANCE):
            return [Slot("input", SlotId(0), SlotType.GRAY)]
        if k in (K.BLUR, K.LEVELS, K.TRANSFORM, K.HSV):
            return [Slot("input", SlotId(0), SlotType.GRAY_OR_RGBA)]
        if k == K.WARP:
            return [
                Slot("input", SlotId(0), SlotType.GRAY_OR_RGBA),
                Slot("strength", SlotId(1), SlotType.GRAY),
            ]
        if k == K.SEPARATE_RGBA:
            return [Slot("input", SlotId(0), SlotType.RGBA)]
        if k == K.COMBINE_RGBA:
            return [
                Slot("red", SlotId(0), SlotType.GRAY),
                Slot("green", SlotId(1), SlotType.GRAY),
                Slot("blue", SlotId(2), SlotType.GRAY),
                Slot("alpha", SlotId(3), SlotType.GRAY),
            ]
        raise TexProError(ErrorKind.INVALID_NODE_TYPE)

    def output_slots(self) -> list[Slot]:
        k = self.node_type.kind
        K = NodeTypeKind
        if k == K.INPUT_GRAY:
            return [Slot("output", SlotId(0), SlotType.GRAY)]
        if k == K.INPUT_RGBA:
            return [Slot("output", SlotId(0), SlotType.RGBA)]
        if k in (K.OUTPUT_GRAY, K.OUTPUT_RGBA):
            return []
        if k == K.GRAPH:
            return self.node_type.payload.output_slots()
        if k in (K.IMAGE, K.EMBED):
            return [Slot("output", SlotId(0), SlotType.RGBA)]
        if k == K.WRITE:
            return []  # sink node; see input_slots note
        if k in (K.VALUE, K.NOISE, K.CURVATURE, K.AMBIENT_OCCLUSION,
                 K.DISTANCE, K.RAMP):
            return [Slot("output", SlotId(0), SlotType.GRAY)]
        if k == K.PATTERN:
            return [
                Slot("mask", SlotId(0), SlotType.GRAY),
                Slot("cells", SlotId(1), SlotType.GRAY),
            ]
        if k == K.VORONOI:
            return [
                Slot("distance", SlotId(0), SlotType.GRAY),
                Slot("borders", SlotId(1), SlotType.GRAY),
                Slot("cells", SlotId(2), SlotType.GRAY),
            ]
        if k == K.MIX:
            return [Slot("output", SlotId(0), SlotType.GRAY_OR_RGBA)]
        if k in (K.HEIGHT_TO_NORMAL, K.GRADIENT_MAP):
            return [Slot("output", SlotId(0), SlotType.RGBA)]
        if k in (K.BLUR, K.LEVELS, K.TRANSFORM, K.WARP, K.HSV):
            return [Slot("output", SlotId(0), SlotType.GRAY_OR_RGBA)]
        if k == K.SEPARATE_RGBA:
            return [
                Slot("red", SlotId(0), SlotType.GRAY),
                Slot("green", SlotId(1), SlotType.GRAY),
                Slot("blue", SlotId(2), SlotType.GRAY),
                Slot("alpha", SlotId(3), SlotType.GRAY),
            ]
        if k == K.COMBINE_RGBA:
            return [Slot("output", SlotId(0), SlotType.RGBA)]
        raise TexProError(ErrorKind.INVALID_NODE_TYPE)

    def input_slot_with_id(self, slot_id: SlotId) -> Slot:
        for slot in self.input_slots():
            if slot.slot_id == slot_id:
                return slot
        raise TexProError(ErrorKind.INVALID_SLOT_ID)

    def output_slot_with_id(self, slot_id: SlotId) -> Slot:
        for slot in self.output_slots():
            if slot.slot_id == slot_id:
                return slot
        raise TexProError(ErrorKind.INVALID_SLOT_ID)

    def input_slot_with_name(self, name: str) -> Slot:
        for slot in self.input_slots():
            if slot.name == name:
                return slot
        raise TexProError(ErrorKind.INVALID_NAME)

    def output_slot_with_name(self, name: str) -> Slot:
        for slot in self.output_slots():
            if slot.name == name:
                return slot
        raise TexProError(ErrorKind.INVALID_NAME)

    def to_json(self) -> dict:
        return {
            "node_id": int(self.node_id),
            "node_type": self.node_type.to_json(),
            "resize_policy": self._resize_policy.to_json(),
            "resize_filter": self._resize_filter.value,
        }

    @staticmethod
    def from_json(data: dict) -> "Node":
        node = Node(NodeType.from_json(data["node_type"]), NodeId(data["node_id"]))
        node.resize_policy = ResizePolicy.from_json(data["resize_policy"])
        node.resize_filter = ResizeFilter(data["resize_filter"])
        return node

    def __repr__(self):
        return f"Node({self.node_type!r}, id={int(self.node_id)})"
