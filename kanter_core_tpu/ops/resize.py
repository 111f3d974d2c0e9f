"""Bit-exact separable resampling + resize-policy resolution.

Replicates `image-0.24.0`'s `imageops::resize` as used by the reference
(`/root/reference/src/shared.rs:141-216`) on f32 `Luma` planes:

- vertical pass then horizontal pass (sample.rs `resize`);
- per output coordinate: `inputx = (outx + 0.5) * ratio`, window
  `[floor(inputx - support·sratio), ceil(inputx + support·sratio))` clamped,
  kernel evaluated at `(i - (inputx - 0.5)) / sratio`, weights normalized by
  their f32 running sum;
- accumulation `t += p * w` in tap order, f32;
- each pass clamps to the f32 `Primitive` bounds `[0, 1]`.

All weight arithmetic is done in strict IEEE f32 (numpy float32 scalar ops)
matching Rust's evaluation order, so outputs are bit-identical. Transcendental
kernels (Gaussian `exp`, Lanczos `sin`) call glibc's FLOAT functions
(`expf`/`sinf` via ctypes) — the same symbols Rust's `f32::exp`/`f32::sin`
lower to on linux-gnu — because the earlier f64-compute-then-round route
double-rounds on ~1/36k weights (measured 1-ulp drift vs the independent C
oracle, tests/test_resize_c_oracle.py); if libm cannot be loaded the f64
route remains as fallback.

The device-side application preserves the tap accumulation order (sequential
adds), so XLA cannot reassociate the sum; padded taps multiply by a weight of
exactly 0.0 and are masked to avoid NaN from `0 * inf`.

Policy resolution mirrors `calculate_size` (`shared.rs:61-139`), including
Rust's `max_by` returning the *last* maximal element on ties.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..errors import ErrorKind, TexProError
from ..geometry import Size
from ..node import ResizeFilter, ResizePolicy, ResizePolicyKind

f32 = np.float32

_SUPPORT = {
    ResizeFilter.NEAREST: f32(0.0),
    ResizeFilter.TRIANGLE: f32(1.0),
    ResizeFilter.CATMULL_ROM: f32(2.0),
    ResizeFilter.GAUSSIAN: f32(3.0),
    ResizeFilter.LANCZOS3: f32(3.0),
}

_PI = f32(math.pi)  # f32::consts::PI

# glibc float transcendentals (the exact symbols Rust f32 math lowers to
# on linux-gnu). expf/sinf have been correctly rounded since glibc 2.28,
# so these are the crate's bits; the f64 fallback differs only in
# astronomically rare double-rounding cases (~1/36k kernel evaluations).
try:
    import ctypes as _ctypes

    _libm = _ctypes.CDLL("libm.so.6")
    _libm.expf.restype = _ctypes.c_float
    _libm.expf.argtypes = [_ctypes.c_float]
    _libm.sinf.restype = _ctypes.c_float
    _libm.sinf.argtypes = [_ctypes.c_float]

    def _expf(x: f32) -> f32:
        return f32(_libm.expf(float(x)))

    def _sinf(x: f32) -> f32:
        return f32(_libm.sinf(float(x)))

except OSError:  # pragma: no cover — non-glibc host

    def _expf(x: f32) -> f32:
        return f32(math.exp(float(x)))

    def _sinf(x: f32) -> f32:
        return f32(math.sin(float(x)))


def _box_kernel(x: f32) -> f32:
    return f32(1.0)


def _triangle_kernel(x: f32) -> f32:
    ax = abs(x)
    if ax < f32(1.0):
        return f32(f32(1.0) - ax)
    return f32(0.0)


def _bc_cubic_spline(x: f32, b: f32, c: f32) -> f32:
    a = abs(x)
    if a < f32(1.0):
        a2 = f32(a * a)
        a3 = f32(a2 * a)
        c3 = f32(f32(f32(12.0) - f32(9.0) * b) - f32(6.0) * c)
        c2 = f32(f32(f32(-18.0) + f32(12.0) * b) + f32(6.0) * c)
        c0 = f32(f32(6.0) - f32(2.0) * b)
        k = f32(f32(f32(c3 * a3) + f32(c2 * a2)) + c0)
    elif a < f32(2.0):
        a2 = f32(a * a)
        a3 = f32(a2 * a)
        c3 = f32(-b - f32(6.0) * c)
        c2 = f32(f32(6.0) * b + f32(30.0) * c)
        c1 = f32(f32(-12.0) * b - f32(48.0) * c)
        c0 = f32(f32(8.0) * b + f32(24.0) * c)
        k = f32(f32(f32(f32(c3 * a3) + f32(c2 * a2)) + f32(c1 * a)) + c0)
    else:
        k = f32(0.0)
    return f32(k / f32(6.0))


def _catmullrom_kernel(x: f32) -> f32:
    return _bc_cubic_spline(x, f32(0.0), f32(0.5))


def _gaussian(x: f32, r: f32) -> f32:
    # ((2π).sqrt() * r).recip() * exp(-x² / (2 r²))
    two_pi = f32(f32(2.0) * _PI)
    norm = f32(f32(1.0) / f32(f32(math.sqrt(float(two_pi))) * r))
    x2 = f32(x * x)
    r2 = f32(r * r)
    arg = f32(-x2 / f32(f32(2.0) * r2))
    return f32(norm * _expf(arg))


def _gaussian_kernel(x: f32) -> f32:
    return _gaussian(x, f32(0.5))


def _sinc(t: f32) -> f32:
    a = f32(t * _PI)
    if t == f32(0.0):
        return f32(1.0)
    return f32(_sinf(a) / a)


def _lanczos3_kernel(x: f32) -> f32:
    if abs(x) < f32(3.0):
        return f32(_sinc(x) * _sinc(f32(x / f32(3.0))))
    return f32(0.0)


_KERNELS = {
    ResizeFilter.NEAREST: _box_kernel,
    ResizeFilter.TRIANGLE: _triangle_kernel,
    ResizeFilter.CATMULL_ROM: _catmullrom_kernel,
    ResizeFilter.GAUSSIAN: _gaussian_kernel,
    ResizeFilter.LANCZOS3: _lanczos3_kernel,
}


@functools.lru_cache(maxsize=4096)
def resample_weights(in_len: int, out_len: int, filt: ResizeFilter):
    """(lefts[int32 out_len], weights[f32 out_len × max_taps]) for one axis.

    Padded taps carry weight exactly 0.0 and indices clamped in-range.
    """
    kernel = _KERNELS[filt]
    support = _SUPPORT[filt]

    ratio = f32(f32(in_len) / f32(out_len))
    sratio = ratio if ratio >= f32(1.0) else f32(1.0)
    src_support = f32(support * sratio)

    lefts = np.zeros(out_len, dtype=np.int32)
    all_ws = []
    max_taps = 1
    for outx in range(out_len):
        inputx = f32(f32(f32(outx) + f32(0.5)) * ratio)
        left = int(math.floor(float(f32(inputx - src_support))))
        left = max(0, min(left, in_len - 1))
        right = int(math.ceil(float(f32(inputx + src_support))))
        right = max(left + 1, min(right, in_len))
        inputx = f32(inputx - f32(0.5))

        ws = []
        total = f32(0.0)
        for i in range(left, right):
            w = kernel(f32(f32(f32(i) - inputx) / sratio))
            ws.append(w)
            total = f32(total + w)
        ws = [f32(w / total) for w in ws]

        lefts[outx] = left
        all_ws.append(ws)
        max_taps = max(max_taps, len(ws))

    weights = np.zeros((out_len, max_taps), dtype=np.float32)
    for outx, ws in enumerate(all_ws):
        weights[outx, : len(ws)] = ws
    return lefts, weights


def _apply_axis0(plane, lefts, weights, in_len: int):
    """Resample along axis 0 of a traced `[H, W]` array. Tap order preserved."""
    import jax
    import jax.numpy as jnp

    # The reference rounds `pixel * weight` and the accumulation separately;
    # XLA:CPU's LLVM backend sinks the zero-weight select and contracts the
    # mul+add into one-rounding FMAs (measured 4517/29100 f32-bit diffs vs
    # the Rust-order numpy result at 173×211→300×97 triangle). `nc_mul` keeps
    # the product separately rounded there and is a plain mul where XLA does
    # not contract (the GPU).
    #
    # KNOWN DIVERGENCE (non-finite planes only): the zero-weight mask below
    # exists because per-row tap windows are padded to max_taps with w=0.0
    # (Rust iterates exact windows and has no pad taps) — but it also masks
    # GENUINE in-window zero weights (integer-ratio Lanczos3/CatmullRom
    # sinc zeros), where Rust computes p·0 and would propagate a NaN pixel
    # into the output. Distinguishing pad from genuine zeros would need a
    # second mask plumbed through all four lockstep consumers for behavior
    # reachable only via divide-by-zero chains; all finite inputs (and all
    # goldens) are bit-identical either way.
    from .exact_math import nc_mul as _mul

    out_len, taps = weights.shape
    lefts_j = jnp.asarray(lefts)
    weights_j = jnp.asarray(weights)

    def tap_contrib(t):
        idx = jnp.clip(lefts_j + t, 0, in_len - 1)
        rows = plane[idx, :]
        w = jax.lax.dynamic_slice_in_dim(weights_j, t, 1, axis=1)  # [out, 1]
        return jnp.where(w == 0.0, jnp.float32(0.0), _mul(rows, w))

    if taps <= 8:
        acc = jnp.zeros((out_len, plane.shape[1]), jnp.float32)
        for t in range(taps):
            idx = lefts + t
            idx = np.minimum(idx, in_len - 1)
            rows = plane[jnp.asarray(idx), :]
            w = weights_j[:, t][:, None]
            acc = acc + jnp.where(w == 0.0, jnp.float32(0.0), _mul(rows, w))
    else:
        def body(t, acc):
            return acc + tap_contrib(t)

        acc = jax.lax.fori_loop(
            0, taps, body, jnp.zeros((out_len, plane.shape[1]), jnp.float32)
        )
    return jnp.clip(acc, 0.0, 1.0)


def _apply_axis0_indexed(plane, idx, weights):
    """`_apply_axis0` with an explicit per-output-row tap index matrix.

    `idx` is int32 `[out, taps]` (positions into `plane`'s axis 0), `weights`
    f32 `[out, taps]`; both may be traced program arguments. Used by the
    blockwise tiled evaluator (`kanter_core_tpu.tiled`) where the producer
    plane is a compacted row band rather than the full canvas: tap order,
    the zero-weight mask, the mul selection, and the per-pass clamp are kept
    identical to `_apply_axis0`, so each output row's bits match whole-plane
    resampling exactly.
    """
    import jax
    import jax.numpy as jnp

    from .exact_math import nc_mul as _mul

    out_len, taps = weights.shape
    if taps <= 8:
        acc = jnp.zeros((out_len, plane.shape[1]), jnp.float32)
        for t in range(taps):
            rows = plane[idx[:, t], :]
            w = weights[:, t][:, None]
            acc = acc + jnp.where(w == 0.0, jnp.float32(0.0), _mul(rows, w))
    else:
        def body(t, acc):
            col = jax.lax.dynamic_index_in_dim(idx, t, axis=1, keepdims=False)
            rows = plane[col, :]
            w = jax.lax.dynamic_slice_in_dim(weights, t, 1, axis=1)
            return acc + jnp.where(w == 0.0, jnp.float32(0.0), _mul(rows, w))

        acc = jax.lax.fori_loop(
            0, taps, body, jnp.zeros((out_len, plane.shape[1]), jnp.float32)
        )
    return jnp.clip(acc, 0.0, 1.0)


def resample_plane(plane, out_size: Size, filt: ResizeFilter):
    """Traceable bit-exact resize of one `[H, W]` plane to `out_size`.

    Matches `imageops::resize`: vertical pass (height) then horizontal pass
    (width), each clamping to [0, 1].
    """
    import jax.numpy as jnp

    if plane.dtype != jnp.float32:
        # bf16 pipeline (DESIGN.md §9: bf16 at rest, f32 in flight): a
        # half-precision stored plane upcasts before the tap math so the
        # resample computes the same f32 bits as the default pipeline
        plane = plane.astype(jnp.float32)
    in_h, in_w = plane.shape
    out_h, out_w = out_size.height, out_size.width

    lefts_v, weights_v = resample_weights(in_h, out_h, filt)
    tmp = _apply_axis0(plane, lefts_v, weights_v, in_h)  # [outH, W]

    lefts_h, weights_h = resample_weights(in_w, out_w, filt)
    return _apply_axis0(tmp.T, lefts_h, weights_h, in_w).T  # [outH, outW]


@functools.lru_cache(maxsize=512)  # shape-keyed; bound for long sessions
def _jitted_resample(in_h: int, in_w: int, out_h: int, out_w: int, filt: ResizeFilter):
    import jax

    return jax.jit(lambda p: resample_plane(p, Size(out_w, out_h), filt))


def resize_plane_eager(plane_array, out_size: Size, filt: ResizeFilter):
    """Jit-cached eager resize of a concrete `[H, W]` device array."""
    in_h, in_w = plane_array.shape
    fn = _jitted_resample(in_h, in_w, out_size.height, out_size.width, filt)
    return fn(plane_array)


# --- resize policy resolution (`shared.rs:61-139`) ---
def calculate_size(slot_datas, edges, policy: ResizePolicy) -> Size:
    kind = policy.kind
    K = ResizePolicyKind
    if kind == K.MOST_PIXELS:
        if not slot_datas:
            return Size(1, 1)
        # Rust `max_by` returns the last maximal element on ties.
        return max(reversed([sd.size() for sd in slot_datas]), key=lambda s: s.pixel_count())
    if kind == K.LEAST_PIXELS:
        if not slot_datas:
            raise TexProError(ErrorKind.GENERIC, "LeastPixels with no inputs")
        return min((sd.size() for sd in slot_datas), key=lambda s: s.pixel_count())
    if kind == K.LARGEST_AXES:
        width, height = 0, 0
        for sd in slot_datas:
            size = sd.size()
            width, height = max(width, size.width), max(height, size.height)
        return Size(width, height)
    if kind == K.SMALLEST_AXES:
        width, height = 2**32 - 1, 2**32 - 1
        for sd in slot_datas:
            size = sd.size()
            width, height = min(width, size.width), min(height, size.height)
        return Size(width, height)
    if kind == K.SPECIFIC_SLOT:
        sorted_edges = sorted(edges, key=lambda e: e.input_slot)
        edge = next((e for e in sorted_edges if e.input_slot == policy.payload), None)
        if edge is None and sorted_edges:
            edge = sorted_edges[0]
        if edge is not None:
            for sd in slot_datas:
                if sd.slot_id == edge.output_slot and sd.node_id == edge.output_id:
                    return sd.size()
            raise TexProError(ErrorKind.GENERIC, "no buffer for SpecificSlot edge")
        return Size(1, 1)
    if kind == K.SPECIFIC_SIZE:
        return policy.payload
    raise TexProError(ErrorKind.GENERIC, f"unknown policy {policy!r}")


def resize_buffers(slot_datas, edges, policy: ResizePolicy, filt: ResizeFilter):
    """Resize every input whose size mismatches the policy-resolved size
    (`shared.rs:141-216`). Planes that already match are shared, not copied."""
    from ..slot_data import SlotData
    from ..slot_image import SlotImage
    from ..transient_buffer import plane_from_device

    if not slot_datas:
        return list(slot_datas)
    size = calculate_size(slot_datas, edges, policy)

    output = []
    for slot_data in slot_datas:
        if slot_data.size() != size:
            planes = [
                plane_from_device(resize_plane_eager(buf.data(), size, filt))
                for buf in slot_data.image.bufs()
            ]
            image = SlotImage(planes)
            output.append(SlotData(slot_data.node_id, slot_data.slot_id, image))
        else:
            output.append(slot_data)
    return output
