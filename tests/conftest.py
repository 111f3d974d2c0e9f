"""Test harness configuration.

Forces the JAX CPU backend with 8 virtual devices so sharding tests run
without real cards, mirroring the reference's single-process integration
suite (`/root/reference/tests/integration_tests.rs`). `chip_smoke.py` runs
the tests marked `gpu` inside its own process on the card; it sets
KANTER_TEST_DEVICE=gpu so this module keeps that backend (one JAX process
per card).

Every test gets a watchdog (the reference uses ntest's #[timeout(20_000)] so
deadlocks fail instead of hanging).
"""

import faulthandler
import os
import threading

import numpy as np
import pytest

if os.environ.get("KANTER_TEST_DEVICE") != "gpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

REFERENCE_DATA = "/root/reference/data"
GOLDEN_DIR = os.path.join(REFERENCE_DATA, "test_compare")

IMAGE_1 = os.path.join(REFERENCE_DATA, "image_1.png")
IMAGE_2 = os.path.join(REFERENCE_DATA, "image_2.png")
HEART_128 = os.path.join(REFERENCE_DATA, "heart_128.png")
HEART_256 = os.path.join(REFERENCE_DATA, "heart_256.png")
HEART_WIDE = os.path.join(REFERENCE_DATA, "heart_wide.png")
HEART_TALL = os.path.join(REFERENCE_DATA, "heart_tall.png")
HEART_110 = os.path.join(REFERENCE_DATA, "heart_110.png")
CLOUDS = os.path.join(REFERENCE_DATA, "clouds.png")
INVERT_GRAPH_JSON = os.path.join(REFERENCE_DATA, "invert_graph.json")

# Per-test watchdog budget. 120 s is generous for a WARM jit cache, but a
# COLD cache on a fresh host compiles every program from scratch and the
# slowest tests blow it — the visible symptom is the suite "passing N dots
# then exiting rc=1 with no summary" (the faulthandler dump lands in
# pytest's capture fd). On a fresh host run with
# `KANTER_TEST_TIMEOUT=900 python -m pytest tests/ -q` once to warm the
# checkout's `.jax_cache`, then the default is fine.
TIMEOUT_SECONDS = int(os.environ.get("KANTER_TEST_TIMEOUT", "120"))


@pytest.fixture(autouse=True)
def _watchdog(request):
    """Deadlock guard: dump all stacks AND abort if a test exceeds the
    budget, so deadlocks fail instead of hanging (reference:
    `#[timeout(20_000)]` on every test). A `watchdog_scale(N)` marker
    multiplies the budget for tests that legitimately exceed it (the
    multi-process multihost test spawns three JAX runtimes on one core)."""
    scale = 1
    marker = request.node.get_closest_marker("watchdog_scale")
    if marker:
        scale = int(marker.args[0])
    faulthandler.dump_traceback_later(TIMEOUT_SECONDS * scale, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def gpu():
    """The GPU device for tests marked `gpu`; skips where JAX has none
    (decided here, at run time, never while modules are collected)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return jax.devices()[0]


@pytest.fixture
def tex_pro():
    from kanter_core_tpu import TextureProcessor

    tp = TextureProcessor(10_000_000)
    yield tp
    tp.shutdown_now()


def golden(name: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(os.path.join(GOLDEN_DIR, name)), dtype=np.uint8)


def render_u8(live_graph, node_id, slot_id=None) -> np.ndarray:
    from kanter_core_tpu import SlotId, TextureProcessor

    return TextureProcessor.buffer_rgba(
        live_graph, node_id, SlotId(0) if slot_id is None else slot_id
    )


def assert_matches_golden(live_graph, node_id, name, slot_id=None):
    data = render_u8(live_graph, node_id, slot_id)
    ref = golden(name)
    assert data.shape[0] == ref.size, f"{name}: size {data.shape} vs {ref.shape}"
    assert np.array_equal(data.reshape(ref.shape), ref), f"{name}: pixels differ"


def planes_bit_equal(a, b) -> bool:
    """Bit-level f32 plane equality with NaN PAYLOADS out of the contract:
    positions must agree on NaN-ness, and every non-NaN bit must match.

    Why: 0/0 produces a quiet NaN whose SIGN/payload depends on how LLVM
    lowered that particular fdiv (measured: the dense compiler's constant
    zero plane gives 0x7fc00000 where the tiled twin's gathered zero rows
    give 0xffc00000 — same graph, same backend). The reference makes no
    NaN-payload guarantee either (Rust leaves it to the ISA), and the u8
    export pins every NaN to 255, so payloads are unobservable; comparing
    them would make parity fail on semantically identical outputs.
    """
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        an, bn = np.isnan(a), np.isnan(b)
        if not np.array_equal(an, bn):
            return False
        au = a.view(np.uint32).copy()
        bu = b.view(np.uint32).copy()
        au[an] = 0
        bu[bn] = 0
        return np.array_equal(au, bu)
    return np.array_equal(a, b)
