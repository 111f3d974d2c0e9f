"""Channel-plane images.

Mirrors `/root/reference/src/slot_image.rs`: an image is either Gray (one f32
plane) or Rgba (four f32 planes `[r, g, b, a]`). Planes are `[H, W]` arrays in
tiered `PlaneBuffer`s and may be shared between images (zero-copy aliasing,
e.g. SeparateRgba / `as_type`).

The u8 export paths reproduce the reference bit-for-bit, including its NaN
behavior: `f32_to_u8` is `((value.clamp(0,1) * 255.).min(255.)) as u8`
(`slot_image.rs:142-144`) where Rust's `min` maps NaN to 255 and `as u8`
truncates toward zero.
"""

from __future__ import annotations

import functools
from typing import Iterable

import numpy as np

from .errors import ErrorKind, TexProError
from .geometry import Size
from .transient_buffer import PlaneBuffer, plane_from_device, plane_from_host


@functools.cache
def _jitted_converters():
    import jax
    import jax.numpy as jnp

    from .ops.common import f32_to_u8  # the one canonical conversion

    from .ops.exact_math import exact_pow as _pow, numerics

    # glibc-rounding div/pow (see ops/exact_math.py). Where the plain divide
    # is correctly rounded it stays — but ONLY for runtime divisors: the
    # algebraic simplifier rewrites division by a compile-time CONSTANT into
    # multiplication by the reciprocal (~1 ulp off on ~39% of inputs for
    # /3, measured), so every constant divisor here hides behind an
    # optimization_barrier to stay a true divide.
    if numerics().div_correctly_rounded:
        from jax import lax

        _div = lambda a, b: a / lax.optimization_barrier(b)  # noqa: E731
    else:
        from .ops.exact_math import corrected_div as _div

    def srgb_to_linear(x):
        # reference formula at `slot_data.rs:100-109` (applied by `to_u8_srgb`
        # despite the method's name, `slot_image.rs:172-175`)
        return jnp.where(
            x <= 0.0,
            x,
            jnp.where(
                x <= jnp.float32(0.04045),
                _div(x, jnp.full_like(x, 12.92)),
                _pow(
                    _div(x + jnp.float32(0.055), jnp.full_like(x, 1.055)),
                    jnp.full_like(x, 2.4),
                ),
            ),
        )

    def pack_u32(r8, g8, b8, a8):
        # Elementwise u32 pack instead of a channel-stack: r|g<<8|b<<16|a<<24
        # stays one fused elementwise op with no layout transpose, and the
        # host views the little-endian u32 buffer as interleaved RGBA bytes
        # for free.
        return (
            r8.astype(jnp.uint32)
            | (g8.astype(jnp.uint32) << 8)
            | (b8.astype(jnp.uint32) << 16)
            | (a8.astype(jnp.uint32) << 24)
        )

    def up(x):
        # bf16 pipeline (DESIGN.md §9): exports and coercions compute in
        # f32 from the stored half-precision plane (no-op for f32)
        return x.astype(jnp.float32) if x.dtype != jnp.float32 else x

    @jax.jit
    def gray_to_u8(g):
        v = f32_to_u8(up(g))
        a = jnp.full_like(v, 255, dtype=jnp.uint8)
        return pack_u32(v, v, v, a)

    @jax.jit
    def rgba_to_u8(r, g, b, a):
        return pack_u32(
            f32_to_u8(up(r)), f32_to_u8(up(g)), f32_to_u8(up(b)), f32_to_u8(up(a))
        )

    @jax.jit
    def gray_to_u8_srgb(g):
        v = f32_to_u8(srgb_to_linear(jnp.clip(up(g), 0.0, 1.0)))
        a = jnp.full_like(v, 255, dtype=jnp.uint8)
        return pack_u32(v, v, v, a)

    @jax.jit
    def rgba_to_u8_srgb(r, g, b, a):
        def conv(x):
            return f32_to_u8(srgb_to_linear(jnp.clip(up(x), 0.0, 1.0)))

        return pack_u32(conv(r), conv(g), conv(b), f32_to_u8(up(a)))

    @jax.jit
    def rgb_mean(r, g, b):
        # gray = ((r + g) + b) / 3 — same association as `slot_image.rs:247-250`;
        # the /3 goes through the gated div so the GPU's loose division
        # can't shift the gray plane's bits off the CPU pipeline
        s = (up(r) + up(g)) + up(b)
        return _div(s, jnp.full_like(s, 3.0))

    return dict(
        gray_to_u8=gray_to_u8,
        rgba_to_u8=rgba_to_u8,
        gray_to_u8_srgb=gray_to_u8_srgb,
        rgba_to_u8_srgb=rgba_to_u8_srgb,
        rgb_mean=rgb_mean,
    )


def _as_plane(obj) -> PlaneBuffer:
    if isinstance(obj, PlaneBuffer):
        return obj
    if isinstance(obj, np.ndarray):
        return plane_from_host(obj)
    return plane_from_device(obj)  # assume jax.Array


import itertools
import threading

_uid_counter = itertools.count(1)
_uid_lock = threading.Lock()


class SlotImage:
    """Gray (1 plane) or Rgba (4 planes, `[r, g, b, a]`)."""

    __slots__ = ("planes", "uid")

    def __init__(self, planes: list[PlaneBuffer]):
        if len(planes) not in (1, 4):
            raise TexProError(ErrorKind.INVALID_BUFFER_COUNT)
        self.planes = planes
        # stable identity token for recipe hashing — unlike id(), never
        # reused after garbage collection
        with _uid_lock:
            self.uid = next(_uid_counter)

    # --- constructors (`slot_image.rs:28-102`) ---
    @staticmethod
    def Gray(plane) -> "SlotImage":
        return SlotImage([_as_plane(plane)])

    @staticmethod
    def Rgba(planes: Iterable) -> "SlotImage":
        planes = [_as_plane(p) for p in planes]
        if len(planes) != 4:
            raise TexProError(ErrorKind.INVALID_BUFFER_COUNT)
        return SlotImage(planes)

    @staticmethod
    def from_value(size: Size, value: float, rgba: bool) -> "SlotImage":
        shape = (size.height, size.width)
        if rgba:
            return SlotImage(
                [
                    plane_from_host(np.full(shape, value, dtype=np.float32)),
                    plane_from_host(np.full(shape, value, dtype=np.float32)),
                    plane_from_host(np.full(shape, value, dtype=np.float32)),
                    plane_from_host(np.full(shape, 1.0, dtype=np.float32)),
                ]
            )
        return SlotImage([plane_from_host(np.full(shape, value, dtype=np.float32))])

    @staticmethod
    def from_buffers_rgba(buffers: list) -> "SlotImage":
        if len(buffers) != 4:
            raise TexProError(ErrorKind.INVALID_BUFFER_COUNT)
        return SlotImage.Rgba(buffers)

    @staticmethod
    def from_buffers_rgb(buffers: list) -> "SlotImage":
        if len(buffers) != 3:
            raise TexProError(ErrorKind.INVALID_BUFFER_COUNT)
        first = _as_plane(buffers[0])
        h, w = first.shape
        alpha = plane_from_host(np.ones((h, w), dtype=np.float32))
        return SlotImage([first, _as_plane(buffers[1]), _as_plane(buffers[2]), alpha])

    def from_self(self) -> "SlotImage":
        return SlotImage(list(self.planes))

    # --- introspection ---
    def is_rgba(self) -> bool:
        return len(self.planes) == 4

    def size(self) -> Size:
        return self.planes[0].size

    def bufs(self) -> list[PlaneBuffer]:
        return list(self.planes)

    def __eq__(self, other):
        if isinstance(other, SlotImage):
            return self.is_rgba() == other.is_rgba()  # discriminant-only eq
        return NotImplemented

    def __hash__(self):
        return hash(self.is_rgba())

    # --- u8 export (`slot_image.rs:146-207`) ---
    def _all_planes_off_device(self) -> bool:
        from .transient_buffer import Tier

        return all(p.tier != Tier.DEVICE for p in self.planes)

    def to_u8(self) -> np.ndarray:
        """Flat row-major interleaved RGBA u8 pixels."""
        if self._all_planes_off_device():
            # spilled planes: pack on host (native C++, numpy fallback)
            # instead of round-tripping hundreds of MB through the device
            from . import native

            if self.is_rgba():
                return native.pack_rgba_u8(*[p.host_data() for p in self.planes])
            return native.pack_gray_u8(self.planes[0].host_data())
        conv = _jitted_converters()
        if self.is_rgba():
            out = conv["rgba_to_u8"](*[p.data() for p in self.planes])
        else:
            out = conv["gray_to_u8"](self.planes[0].data())
        # little-endian u32 → interleaved RGBA bytes, zero-copy
        return np.ascontiguousarray(out).view(np.uint8).reshape(-1)

    def to_u8_srgb(self) -> np.ndarray:
        import jax

        conv = _jitted_converters()
        if self._all_planes_off_device():
            # spilled planes: run the sRGB pack on the in-process XLA:CPU
            # backend instead of round-tripping hundreds of MB through the
            # device — the same economy to_u8's native
            # host pack buys. u8 outputs are identical: the golden contract
            # is the CPU backend, and the corrected div/pow formulations
            # agree with glibc after u8 quantization on the full grid.
            with jax.default_device(jax.devices("cpu")[0]):
                if self.is_rgba():
                    out = conv["rgba_to_u8_srgb"](
                        *[p.host_data() for p in self.planes]
                    )
                else:
                    out = conv["gray_to_u8_srgb"](self.planes[0].host_data())
                out = np.asarray(out)
        elif self.is_rgba():
            out = conv["rgba_to_u8_srgb"](*[p.data() for p in self.planes])
        else:
            out = conv["gray_to_u8_srgb"](self.planes[0].data())
        return np.ascontiguousarray(out).view(np.uint8).reshape(-1)

    def to_numpy_rgba(self) -> np.ndarray:
        """`[H, W, 4]` u8 view of `to_u8` (convenience)."""
        size = self.size()
        return self.to_u8().reshape(size.height, size.width, 4)

    # --- type coercion (`slot_image.rs:212-256`) ---
    def as_type(self, rgba: bool) -> "SlotImage":
        if self.is_rgba() == rgba:
            return SlotImage(list(self.planes))
        if not self.is_rgba():
            # gray → rgba: alias the gray plane ×3, fresh alpha=1 plane
            h, w = self.planes[0].shape
            alpha = plane_from_host(np.ones((h, w), dtype=np.float32))
            g = self.planes[0]
            return SlotImage([g, g, g, alpha])
        # rgba → gray: mean of RGB
        conv = _jitted_converters()
        r, g, b = (self.planes[i].data() for i in range(3))
        return SlotImage([plane_from_device(conv["rgb_mean"](r, g, b))])
