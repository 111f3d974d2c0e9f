"""Tiered channel-plane buffers (device memory → host DRAM → disk).

Device-memory rework of `/root/reference/src/transient_buffer.rs`. The reference
keeps every channel plane in a `TransientBuffer` that is either in RAM or
spilled to disk (salted-hash file under `$TMPDIR/vismut_cache`,
`transient_buffer.rs:98-183`), with a 1 ms manager thread enforcing an LRU
memory watermark (`transient_buffer.rs:351-406`).

Here a plane is an f32 `[H, W]` array living in one of three tiers:

- ``DEVICE``: a `jax.Array` resident in device memory (the compute tier);
- ``HOST``: a NumPy array in host DRAM (first spill tier);
- ``STORAGE``: a salted-hash-verified file on disk (second spill tier,
  preserving the reference's crash-detecting reload semantics).

``in_memory`` maps to "device-resident" — the analog of the reference's
RAM-vs-disk distinction for a machine whose working memory is the device's. A manager
thread (`PlaneBufferQueue.thread_loop`) enforces the device watermark by
evicting least-recently-touched planes device→host, and an optional host
watermark by spilling host→disk.
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from enum import Enum
from typing import Optional

import numpy as np

from .errors import ErrorKind, TexProError
from .geometry import Size

# per-process spill directory: files are deleted on reload/drop, but a
# crashed process can't clean up after itself — stale sibling directories
# whose owning pid is gone are swept on startup (`_sweep_stale_spill_dirs`)
_CACHE_ROOT = os.path.join(tempfile.gettempdir(), "kanter_plane_cache")
_CACHE_DIR = os.path.join(_CACHE_ROOT, str(os.getpid()))


def _sweep_stale_spill_dirs() -> None:
    try:
        entries = os.listdir(_CACHE_ROOT)
    except OSError:
        return
    for name in entries:
        if not name.isdigit() or name == str(os.getpid()):
            continue
        try:
            os.kill(int(name), 0)
            continue  # owner still alive
        except ProcessLookupError:
            pass
        except OSError:
            continue
        stale = os.path.join(_CACHE_ROOT, name)
        try:
            for f in os.listdir(stale):
                try:
                    os.remove(os.path.join(stale, f))
                except OSError:
                    pass
            os.rmdir(stale)
        except OSError:
            pass

class Tier(Enum):
    DEVICE = "device"
    HOST = "host"
    STORAGE = "storage"


class AtomicUsize:
    """Shared mutable counter (reference: `Arc<AtomicUsize>`)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0):
        self._value = int(value)
        self._lock = threading.Lock()

    def store(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    def load(self) -> int:
        return self._value


def _hash_plane(salt: int, data: bytes) -> str:
    """Salted content hash for spill-file names (verified on reload;
    reference `transient_buffer.rs:98-133`). Uses the native C++ hash when
    built, hashlib otherwise."""
    from . import native

    return native.salted_hash64(data, salt)


class PlaneBuffer:
    """One channel plane in one of three memory tiers.

    Analog of `TransientBufferContainer` + `TransientBuffer`
    (`transient_buffer.rs:28-247`). The size is cached so size queries never
    fault data in (`transient_buffer.rs:188-201`).
    """

    __slots__ = ("_lock", "_tier", "_device", "_host", "_path", "_salt", "_height",
                 "_width", "_queue", "_dtype", "__weakref__")

    def __init__(self, *, device=None, host=None):
        self._lock = threading.RLock()
        self._queue = None  # PlaneBufferQueue that manages this buffer, if any
        if device is not None:
            self._tier = Tier.DEVICE
            self._device = device
            self._host = None
            self._height, self._width = device.shape
            self._dtype = np.dtype(device.dtype)
        else:
            host = np.asarray(host)
            if host.dtype.name in ("bfloat16", "float16"):
                # half-precision pipeline plane (bf16, DESIGN.md §9):
                # preserve it — upcasting here would silently double the
                # committed footprint the mode exists to halve
                host = np.ascontiguousarray(host)
            else:
                host = np.ascontiguousarray(host, dtype=np.float32)
            self._tier = Tier.HOST
            self._device = None
            self._host = host
            self._height, self._width = host.shape
            self._dtype = host.dtype
        self._path = None
        self._salt = None

    # --- introspection ---
    @property
    def size(self) -> Size:
        return Size(self._width, self._height)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._height, self._width)

    def bytes(self) -> int:
        return self._height * self._width * self._dtype.itemsize

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def in_memory(self) -> bool:
        """True when device-resident (reference: RAM-vs-disk, here HBM-vs-spill)."""
        return self._tier == Tier.DEVICE

    @property
    def tier(self) -> Tier:
        return self._tier

    # --- access ---
    def data(self):
        """The plane as a device `jax.Array`, faulting it in if spilled.

        Faulting is synchronous (unlike the reference's request-flag + manager
        round-trip at `transient_buffer.rs:203-217`) and holds only the PLANE
        lock: a disk reload + `device_put` of a large plane takes a while,
        and holding the queue lock across it froze every other plane access
        (and, through `add_slot_data` under the LiveGraph lock, commits and
        edits too). The LRU move happens after, under the queue lock alone
        (same release-then-reacquire pattern as `try_data`; taking the queue
        lock while holding the plane lock would invert the documented
        queue→plane order and deadlock against the evictor). The evictor may
        therefore pick a just-faulted plane as victim in the gap — wasted
        work, not a correctness issue: the returned `device` reference keeps
        the caller's array valid, and the next access re-faults.
        """
        queue = self._queue
        with self._lock:
            if self._tier != Tier.DEVICE:
                self._fault_in_locked()
            device = self._device
        if queue is not None:
            with queue._lock:
                queue._move_to_back_locked(self)
        return device

    def try_data(self):
        """Non-blocking accessor: the device array if already resident, else
        raises (reference `try_transient_buffer`, `transient_buffer.rs:219-228`,
        which also flags the buffer for fault-in — here the flag is an LRU
        touch so the manager keeps it warm)."""
        queue = self._queue
        with self._lock:
            if self._tier == Tier.DEVICE:
                device = self._device
            else:
                device = None
        if device is not None:
            if queue is not None:
                with queue._lock:
                    queue._move_to_back_locked(self)
            return device
        raise TexProError(ErrorKind.GENERIC, "plane not device-resident")

    def host_data(self) -> np.ndarray:
        """The plane as a host ndarray without promoting it to the device."""
        with self._lock:
            if self._tier == Tier.DEVICE:
                return np.asarray(self._device)
            if self._tier == Tier.STORAGE:
                self._load_from_storage_locked()
                self._tier = Tier.HOST
            return self._host

    def _fault_in_locked(self) -> None:
        import jax

        if self._tier == Tier.STORAGE:
            self._load_from_storage_locked()
        self._device = jax.device_put(self._host)
        self._host = None
        self._tier = Tier.DEVICE

    # --- tier transitions (manager thread) ---
    def begin_evict(self) -> bool:
        """Phase 1 of a pipelined DEVICE→HOST eviction: start the async
        device→host copy without blocking, so the manager can overlap many
        victims' transfers instead of serializing one round trip per plane.
        Returns True
        if this plane is a device-resident eviction candidate."""
        with self._lock:
            if self._tier != Tier.DEVICE:
                return False
            try:
                self._device.copy_to_host_async()
            except AttributeError:  # non-jax array (tests) — phase 2 copies
                pass
            return True

    def evict_to_host(self) -> bool:
        """DEVICE → HOST (phase 2 when `begin_evict` ran: the async copy has
        landed and `np.asarray` is a cheap materialization). Returns True if
        a move happened."""
        with self._lock:
            if self._tier != Tier.DEVICE:
                return False
            self._host = np.asarray(self._device)
            self._device = None
            self._tier = Tier.HOST
            return True

    def spill_to_storage(self, host_only: bool = False) -> bool:
        """HOST → STORAGE with a salted content hash as the file name; the hash
        is verified on reload and the file deleted, erroring on mismatch
        (`transient_buffer.rs:98-183`). `host_only=True` refuses DEVICE-tier
        planes ATOMICALLY (under the plane lock): the tier manager's victim
        selection happens outside this lock, and a plane that faulted hot in
        the gap must not be demoted straight to disk — the lock-free tier
        re-check at the call site was a TOCTOU guard in name only."""
        with self._lock:
            if self._tier == Tier.DEVICE:
                if host_only:
                    return False
                self.evict_to_host()
            if self._tier != Tier.HOST:
                return False
            salt = random.getrandbits(64)
            raw = self._host.tobytes()
            digest = _hash_plane(salt, raw)
            os.makedirs(_CACHE_DIR, exist_ok=True)
            path = os.path.join(_CACHE_DIR, digest)
            with open(path, "wb") as f:
                f.write(raw)
            self._path = path
            self._salt = salt
            self._host = None
            self._tier = Tier.STORAGE
            return True

    def _load_from_storage_locked(self) -> None:
        path = self._path
        with open(path, "rb") as f:
            raw = f.read()
        digest = _hash_plane(self._salt, raw)
        try:
            os.remove(path)
        except OSError:
            pass
        if digest != os.path.basename(path):
            raise TexProError(ErrorKind.GENERIC, "spill file hash mismatch")
        self._host = (
            np.frombuffer(raw, dtype=self._dtype)
            .reshape(self._height, self._width)
            .copy()
        )
        self._path = None
        self._salt = None

    def __del__(self):
        if getattr(self, "_path", None):
            try:
                os.remove(self._path)
            except OSError:
                pass


def plane_from_host(array) -> PlaneBuffer:
    # the constructor normalizes dtype (f32, preserving half-precision
    # pipeline planes — DESIGN.md §9)
    return PlaneBuffer(host=array)


def plane_from_device(array) -> PlaneBuffer:
    return PlaneBuffer(device=array)


def pixel_buffer(value: float) -> PlaneBuffer:
    """A 1×1 gray plane (`/root/reference/src/node/mod.rs:239-243`)."""
    return PlaneBuffer(host=np.full((1, 1), value, dtype=np.float32))


class PlaneBufferQueue:
    """LRU spill manager (analog of `TransientBufferQueue`,
    `transient_buffer.rs:250-434`).

    Holds every live plane once (deduplicated by identity), drops planes no
    one else references, moves touched planes to the back, and evicts from the
    front while the device-resident byte count exceeds `memory_threshold`.
    """

    TICK_SECONDS = 0.001

    def __init__(self, memory_threshold: AtomicUsize, shutdown, host_threshold: Optional[AtomicUsize] = None):
        _sweep_stale_spill_dirs()
        # id(buf) → buf, ordered front (coldest) → back (hottest): O(1)
        # LRU moves on every plane touch instead of O(n) deque scans
        self._entries: "OrderedDict[int, PlaneBuffer]" = OrderedDict()
        self.memory_threshold = memory_threshold
        self.host_threshold = host_threshold
        self.shutdown = shutdown
        self._incoming: list[PlaneBuffer] = []
        # One reentrant lock guards queue order, membership, and eviction.
        # Lock order everywhere is queue lock → plane lock (see
        # PlaneBuffer.data), so LRU moves are atomic with fault-ins.
        self._lock = threading.RLock()

    # --- ingestion (`transient_buffer.rs:297-345`) ---
    def add_buffer(self, buffer: PlaneBuffer) -> None:
        with self._lock:
            self._incoming.append(buffer)

    def add_slot_data(self, slot_data) -> None:
        for buf in slot_data.image.bufs():
            self.add_buffer(buf)

    @property
    def queue(self) -> list:
        """Snapshot of managed planes, coldest first (introspection/tests)."""
        with self._lock:
            return list(self._entries.values())

    def _move_to_back_locked(self, buffer: PlaneBuffer) -> None:
        if id(buffer) in self._entries:
            self._entries.move_to_end(id(buffer))
        # else: not yet adopted; handle_incoming will append it

    def _handle_incoming_locked(self) -> None:
        incoming, self._incoming = self._incoming, []
        for buf in incoming:
            if id(buf) in self._entries:
                continue
            buf._queue = self
            self._entries[id(buf)] = buf
            if not buf.in_memory():
                self._entries.move_to_end(id(buf), last=False)  # coldest end

    # --- accounting ---
    def bytes_memory(self) -> int:
        with self._lock:
            return sum(b.bytes() for b in self._entries.values() if b.tier == Tier.DEVICE)

    def bytes_host(self) -> int:
        with self._lock:
            return sum(b.bytes() for b in self._entries.values() if b.tier == Tier.HOST)

    def bytes_storage(self) -> int:
        with self._lock:
            return sum(b.bytes() for b in self._entries.values() if b.tier == Tier.STORAGE)

    def _sweep_orphans_locked(self) -> None:
        # A plane referenced only by this queue belongs to no SlotData anymore
        # (reference: `Arc::strong_count == 1`, `transient_buffer.rs:364`).
        # CPython refcount via direct dict access: dict value + getrefcount
        # argument = 2. (Iterating .items() would add a tuple reference and
        # make every plane look alive.)
        dead = [
            key
            for key in list(self._entries)
            if sys.getrefcount(self._entries[key]) <= 2
        ]
        for key in dead:
            del self._entries[key]

    def tick(self) -> bool:
        """One manager pass. Returns True if it did any work (used by the
        thread loop to back off while idle instead of burning a core on
        1 kHz full-queue scans, the reference's fixed cadence,
        `transient_buffer.rs:409`).

        The queue lock covers only bookkeeping and victim SELECTION; the
        blocking device→host materializations and disk writes run outside
        it (each plane's own lock serializes racing fault-ins). Holding the
        queue lock across a transfer would stall every `data()` fault-in —
        and, transitively, commit and read paths — for the transfer's
        duration. A plane
        faulted back in between selection and eviction just gets re-evicted
        skipped by `evict_to_host`'s own tier check or re-promoted on its
        next touch; under-eviction self-heals on the next tick."""
        worked = False
        evict_victims: list = []
        spill_victims: list = []
        with self._lock:
            before = len(self._entries)
            worked |= bool(self._incoming)
            self._handle_incoming_locked()
            self._sweep_orphans_locked()
            worked |= len(self._entries) != before

            threshold = self.memory_threshold.load()
            in_memory = sum(
                b.bytes() for b in self._entries.values() if b.tier == Tier.DEVICE
            )
            if in_memory > threshold:
                # two-phase: start ALL victims' async device→host copies,
                # then materialize — transfers overlap instead of paying one
                # blocking round trip per plane
                pending = in_memory
                for buf in list(self._entries.values()):
                    if pending <= threshold or self.shutdown.load():
                        # don't START async device→host copies during
                        # shutdown: an in-flight transfer abandoned at
                        # interpreter exit unwinds through C++ and aborts
                        break
                    if buf.begin_evict():
                        evict_victims.append(buf)
                        pending -= buf.bytes()

            if self.host_threshold is not None:
                host_threshold = self.host_threshold.load()
                on_host = sum(
                    b.bytes() for b in self._entries.values() if b.tier == Tier.HOST
                )
                if on_host > host_threshold:
                    for buf in list(self._entries.values()):
                        if on_host <= host_threshold:
                            break
                        if buf.tier == Tier.HOST:
                            spill_victims.append(buf)
                            on_host -= buf.bytes()

        for buf in evict_victims:
            if self.shutdown.load():
                return worked  # abandon remaining transfers: exiting with a
                # daemon mid-device-transfer aborts the process from C++
            if buf.evict_to_host():
                worked = True
        for buf in spill_victims:
            if self.shutdown.load():
                return worked
            # host_only: a plane faulted back to DEVICE since selection must
            # not be silently evicted+spilled — the refusal is atomic under
            # the plane lock (a bare tier re-check here raced fault-ins)
            if buf.spill_to_storage(host_only=True):
                worked = True
        return worked

    def dump(self) -> str:
        """Debug listing of every managed plane and its tier (reference:
        `Display for TransientBufferQueue`, `transient_buffer.rs:257-285`)."""
        with self._lock:
            entries = list(self._entries.values())
            lines = [
                f"Thres: {self.memory_threshold.load()}",
                f"Devic: {sum(b.bytes() for b in entries if b.tier == Tier.DEVICE)}",
                f"Host : {sum(b.bytes() for b in entries if b.tier == Tier.HOST)}",
                f"Stora: {sum(b.bytes() for b in entries if b.tier == Tier.STORAGE)}",
            ]
            tags = {Tier.DEVICE: "DEV", Tier.HOST: "HST", Tier.STORAGE: "STO"}
            for buf in entries:
                lines.append(f"{tags[buf.tier]} {buf.bytes():>10} {buf.size} 0x{id(buf):x}")
            return "\n".join(lines)

    def __str__(self) -> str:
        return self.dump()

    IDLE_TICK_SECONDS = 0.02

    def thread_loop(self) -> None:
        while not self.shutdown.load():
            worked = self.tick()
            time.sleep(self.TICK_SECONDS if worked else self.IDLE_TICK_SECONDS)
