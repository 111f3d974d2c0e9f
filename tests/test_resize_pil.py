"""Independent resize oracle: Pillow's C resampler.

VERDICT r2 missing #6: the CatmullRom/Gaussian/Lanczos3 fixtures were
self-referential (generated by this repo's own f64 oracle). No Rust
toolchain exists here to run `image-0.24.0` itself, but Pillow implements
the SAME classic separable resample (Heckbert-style: support windows
scaled by the ratio, normalized taps over `(i+0.5)·scale − 0.5` centers)
in independent C code with matching filter definitions:

- Triangle   ↔ `Image.BILINEAR` (support 1)
- CatmullRom ↔ `Image.BICUBIC`  (Pillow's bicubic a = −0.5 IS Catmull-Rom)
- Lanczos3   ↔ `Image.LANCZOS`  (a = 3)

Measured agreement is a few f32 ULPs (max ~2e-6 over smooth and noise
fields) — far below any plausible shared-bug coincidence, so this breaks
the self-referential loop for three of the five filters. Not coverable by
Pillow: Gaussian (no PIL analog; stays on the f64 oracle + frozen
fixtures) and Nearest (tie-break index selection differs by convention,
and a tolerance comparison is meaningless for a selector).

Inputs stay mid-range/smooth-ish so the engine's per-pass [0,1] clamp
(`image-0.24.0` parity, `ops/resize.py`) never fires — Pillow mode-'F'
doesn't clamp, and clamping is deliberately NOT part of what this oracle
checks (the frozen-fixture suite covers it).
"""

import numpy as np
import pytest

# Pillow is the oracle here and optional elsewhere (the main path needs it
# only for Image nodes): skip where it is absent, e.g. a card-only run
Image = pytest.importorskip("PIL.Image")

import jax

from kanter_core_tpu.geometry import Size
from kanter_core_tpu.node import ResizeFilter
from kanter_core_tpu.ops.resize import resample_plane

PAIRS = [
    (ResizeFilter.TRIANGLE, Image.BILINEAR),
    (ResizeFilter.CATMULL_ROM, Image.BICUBIC),
    (ResizeFilter.LANCZOS3, Image.LANCZOS),
]

SHAPES = [
    (97, 173, 300, 121),   # up in H, down in W, awkward primes
    (256, 256, 100, 100),  # plain downscale
    (64, 48, 200, 300),    # plain upscale
    (110, 110, 128, 128),  # the irregular_sizes golden's ratio
    (1, 1, 33, 57),        # Value-node upscale path
]


def _smooth(h, w):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    v = (
        0.5
        + 0.2 * np.sin(2 * np.pi * x / 37) * np.cos(2 * np.pi * y / 23)
        + 0.15 * np.sin(2 * np.pi * (x + y) / 101)
    )
    return v.astype(np.float32)


@pytest.mark.parametrize("filt,pil", PAIRS, ids=lambda p: getattr(p, "name", str(p)))
@pytest.mark.parametrize("shape", SHAPES)
def test_resample_matches_pillow_smooth(filt, pil, shape):
    ih, iw, oh, ow = shape
    src = _smooth(ih, iw)
    ours = np.asarray(jax.jit(lambda p: resample_plane(p, Size(ow, oh), filt))(src))
    ref = np.asarray(Image.fromarray(src, mode="F").resize((ow, oh), pil))
    assert ours.shape == ref.shape
    assert float(np.abs(ours - ref).max()) < 1e-5


@pytest.mark.parametrize("filt,pil", PAIRS, ids=lambda p: getattr(p, "name", str(p)))
def test_resample_matches_pillow_noise_downscale(filt, pil):
    rng = np.random.default_rng(int(filt.value.encode()[0]))
    src = (0.2 + 0.6 * rng.random((256, 256))).astype(np.float32)
    ours = np.asarray(jax.jit(lambda p: resample_plane(p, Size(100, 90), filt))(src))
    ref = np.asarray(Image.fromarray(src, mode="F").resize((100, 90), pil))
    assert float(np.abs(ours - ref).max()) < 1e-5
