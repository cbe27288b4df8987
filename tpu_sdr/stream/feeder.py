"""Host feeders: pull u8 I/Q blocks from a source and stream them to the
device data plane.

The reference's ingest is a blocking two-thread pipeline
(/root/reference/examples/simple_fm.rs:55-63, rtl_tcp.rs:378-400).  The
device-fed equivalent (SURVEY.md §7 layer 3): a reader thread fills a
bounded queue; the consumer overlaps ``jax.device_put`` of block N+1 with
device compute on block N (double buffering), since JAX dispatch is async.

Sources:

* :class:`FileSource` — raw capture file (simple_fm.rs READ_FROM_FILE mode),
* :class:`DeviceSource` — an opened :class:`tpu_sdr.api.RtlSdr`,
* :class:`RtlTcpClientSource` — client side of the rtl_tcp protocol, so any
  rtl_tcp server (including the reference implementation) can feed the
  device.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Iterator

import numpy as np

from tpu_sdr import DEFAULT_BUF_LENGTH


class BlockSource:
    """A source of fixed-size u8 I/Q blocks."""

    def read_block(self, length: int) -> bytes | None:
        """Return exactly ``length`` bytes, or None at end of stream."""
        raise NotImplementedError

    def fileno(self) -> int | None:
        """OS fd for zero-Python native pumping, or None."""
        return None

    @property
    def wants_backpressure(self) -> bool:
        """True if overrun should stall the producer instead of dropping
        (replayable sources); live radios drop, like the reference feeder."""
        return False

    def close(self) -> None: ...


class FileSource(BlockSource):
    def __init__(self, path: str, loop: bool = False):
        self._f = open(path, "rb")
        self._loop = loop

    def read_block(self, length: int) -> bytes | None:
        data = self._f.read(length)
        while len(data) < length and self._loop:
            self._f.seek(0)
            data += self._f.read(length - len(data))
        if len(data) < length:
            return None
        return data

    def fileno(self) -> int | None:
        return self._f.fileno()

    @property
    def loop(self) -> bool:
        return self._loop

    @property
    def wants_backpressure(self) -> bool:
        return True

    def close(self) -> None:
        self._f.close()


class DeviceSource(BlockSource):
    def __init__(self, sdr):
        self.sdr = sdr

    def read_block(self, length: int) -> bytes | None:
        data = self.sdr.read_sync(length)
        return data if len(data) == length else None

    def close(self) -> None:
        self.sdr.close()


class RtlTcpClientSource(BlockSource):
    """rtl_tcp protocol client (the counterpart of
    /root/reference/examples/rtl_tcp.rs's server side).

    Reads the 12-byte ``RTL0`` handshake, exposes tuner type/gain count, and
    sends 5-byte control commands.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 1234, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        magic = self._read_exact(12)
        if magic is None or magic[:4] != b"RTL0":
            raise ConnectionError("Not an rtl_tcp server (bad handshake)")
        self.tuner_type, self.gain_count = struct.unpack(">II", magic[4:12])
        # Back to a blocking fd once connected: a Python socket timeout sets
        # O_NONBLOCK, which would starve fd-level readers (the native pump).
        self.sock.settimeout(None)

    def command(self, cmd: int, param: int) -> None:
        self.sock.sendall(struct.pack(">BI", cmd, param & 0xFFFFFFFF))

    def set_frequency(self, hz: int) -> None:
        self.command(0x01, hz)

    def set_sample_rate(self, hz: int) -> None:
        self.command(0x02, hz)

    def set_gain_mode(self, manual: bool) -> None:
        self.command(0x03, int(manual))

    def set_gain(self, tenth_db: int) -> None:
        self.command(0x04, tenth_db)

    def set_test_mode(self, on: bool) -> None:
        self.command(0x07, int(on))

    def read_block(self, length: int) -> bytes | None:
        return self._read_exact(length)

    def fileno(self) -> int | None:
        return self.sock.fileno()

    def _read_exact(self, n: int) -> bytes | None:
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return data

    def close(self) -> None:
        self.sock.close()


def _native_runtime():
    try:
        import tpu_sdr.native as nat
        return nat if nat.available() else None
    except Exception:
        return None


class BlockFeeder:
    """Producer (native pump or reader thread) + bounded queue + numpy
    hand-off.

    The bounded queue reproduces the reference's backpressure semantics
    (rtl_tcp.rs:24,365).  When the native runtime is built, the queue is the
    C++ ring buffer; sources exposing an OS fd (files, rtl_tcp sockets) are
    pumped entirely by the native reader thread with no Python in the byte
    path — the framework analog of the reference's native receive thread
    (simple_fm.rs:89-132).  ``blocks()`` yields numpy u8 arrays ready for
    ``jax.device_put``.
    """

    def __init__(self, source: BlockSource, block_bytes: int = DEFAULT_BUF_LENGTH,
                 queue_blocks: int = 16, native: bool | None = None):
        self.source = source
        self.block_bytes = block_bytes
        self._queue_blocks = queue_blocks
        self._nat = _native_runtime() if native in (None, True) else None
        if native is True and self._nat is None:
            raise RuntimeError("native runtime requested but unavailable")
        self._ring = None
        self._pump = None
        self._q: "queue.Queue[bytes | None] | None" = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._py_dropped = 0

    @property
    def is_native(self) -> bool:
        return self._ring is not None

    @property
    def dropped(self) -> int:
        if self._ring is not None:
            return self._ring.dropped + self._py_dropped
        return self._py_dropped

    def start(self) -> "BlockFeeder":
        if self._nat is not None:
            self._ring = self._nat.NativeRing(self.block_bytes, self._queue_blocks)
            fd = self.source.fileno()
            loop = bool(getattr(self.source, "loop", False))
            if fd is not None:
                # Fully native path: C++ thread reads the fd straight into
                # the ring; Python only pops finished blocks.
                self._pump = self._nat.NativePump(
                    self._ring, fd, loop_file=loop,
                    block_on_full=self.source.wants_backpressure)
                return self
            # Source needs Python to produce bytes (e.g. a device object);
            # a thin thread pushes into the native ring.
            self._thread = threading.Thread(target=self._reader_native, daemon=True)
            self._thread.start()
            return self
        self._q = queue.Queue(maxsize=self._queue_blocks)
        self._thread = threading.Thread(target=self._reader_py, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._pump is not None:
            self._pump.stop()
            self._pump = None
        if self._ring is not None:
            self._ring.set_eof()
        if self._q is not None:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.source.close()

    def _reader_native(self) -> None:
        backpressure = self.source.wants_backpressure
        while not self._stop.is_set():
            data = self.source.read_block(self.block_bytes)
            if data is None:
                break
            while not self._ring.push(data):
                if not backpressure:
                    break  # dropped; ring counts it
                if self._stop.wait(0.005):
                    break
        self._ring.set_eof()

    def _reader_py(self) -> None:
        while not self._stop.is_set():
            data = self.source.read_block(self.block_bytes)
            if data is None:
                break
            try:
                self._q.put(data, timeout=1.0)
            except queue.Full:
                self._py_dropped += 1
        # The end-of-stream sentinel must not be lost to a momentarily-full
        # queue (the consumer would block forever); keep trying until it
        # lands or a stop is requested (stop() enqueues its own sentinel).
        while not self._stop.is_set():
            try:
                self._q.put(None, timeout=0.2)
                return
            except queue.Full:
                continue

    def blocks(self) -> Iterator[np.ndarray]:
        if self._ring is not None:
            while True:
                try:
                    blk = self._ring.pop(timeout_ms=30_000)
                except TimeoutError:
                    return
                if blk is None:
                    return
                yield blk
            return
        while True:
            data = self._q.get()
            if data is None:
                return
            yield np.frombuffer(data, dtype=np.uint8)

    def device_blocks(self, device=None):
        """Double-buffered device feed: ``device_put`` block N+1 while the
        consumer computes on block N (JAX async dispatch overlaps the H2D
        copy with compute)."""
        import jax

        pending = None
        for host_block in self.blocks():
            nxt = jax.device_put(host_block, device)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending
