"""Pythonic wrappers over the native host runtime (see package docstring).

Every entry point has a numpy fallback so the framework works without the
C++ toolchain; the native paths are the production ones (the reference's
equivalents are native Rust: bounded channels rtl_tcp.rs:365, rotate_90 NEON
simple_fm.rs:300-334, s16 output simple_fm.rs:430-438).
"""

from __future__ import annotations

import ctypes

import numpy as np

import tpu_sdr.native as _native


def _lib():
    lib = _native.load()
    if lib is None:
        raise RuntimeError("native tpusdr_io library unavailable")
    return lib


class NativeRing:
    """Fixed-block bounded ring buffer (the rtl_tcp.rs:24,365 queue)."""

    def __init__(self, block_bytes: int, capacity: int):
        self._lib = _lib()
        self._ptr = self._lib.tsdr_ring_create(block_bytes, capacity)
        if not self._ptr:
            raise RuntimeError("ring allocation failed")
        self.block_bytes = block_bytes
        self.capacity = capacity

    def push(self, block: bytes | np.ndarray) -> bool:
        """Non-blocking; False means the block was dropped (queue full)."""
        data = bytes(block) if not isinstance(block, bytes) else block
        if len(data) != self.block_bytes:
            raise ValueError(f"block must be exactly {self.block_bytes} bytes")
        return self._lib.tsdr_ring_push(self._ptr, data) == 0

    def pop(self, timeout_ms: int = -1) -> np.ndarray | None:
        """Blocking pop -> u8 array; None on end-of-stream.

        Raises TimeoutError if ``timeout_ms`` >= 0 elapses first.
        """
        out = np.empty(self.block_bytes, dtype=np.uint8)
        rc = self._lib.tsdr_ring_pop(
            self._ptr, out.ctypes.data_as(ctypes.c_void_p), timeout_ms)
        if rc == 1:
            return out
        if rc == 0:
            raise TimeoutError("ring pop timed out")
        return None

    def __len__(self) -> int:
        return int(self._lib.tsdr_ring_count(self._ptr))

    @property
    def dropped(self) -> int:
        return int(self._lib.tsdr_ring_dropped(self._ptr))

    def set_eof(self) -> None:
        self._lib.tsdr_ring_set_eof(self._ptr)

    @property
    def eof(self) -> bool:
        return bool(self._lib.tsdr_ring_eof(self._ptr))

    def close(self) -> None:
        if self._ptr:
            self._lib.tsdr_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativePump:
    """Native reader thread: fd -> ring (the simple_fm.rs:89-132 receive
    thread, in C++)."""

    def __init__(self, ring: NativeRing, fd: int, loop_file: bool = False,
                 block_on_full: bool = False):
        self._lib = _lib()
        self.ring = ring
        self._ptr = self._lib.tsdr_pump_start(
            ring._ptr, fd, int(loop_file), int(block_on_full))

    @property
    def blocks_read(self) -> int:
        return int(self._lib.tsdr_pump_blocks(self._ptr))

    def stop(self) -> None:
        if self._ptr:
            self._lib.tsdr_pump_stop(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover
        try:
            self.stop()
        except Exception:
            pass


def u8_iq_to_planar_f32(iq: np.ndarray, phase: int = 0,
                        scale: float = 1.0 / 127.5):
    """u8 interleaved I/Q -> (re, im) f32, centered/scaled + fs/4 rotated."""
    iq = np.ascontiguousarray(iq, dtype=np.uint8)
    n = iq.size // 2
    if _native.available():
        re = np.empty(n, dtype=np.float32)
        im = np.empty(n, dtype=np.float32)
        _lib().tsdr_u8_iq_to_planar_f32(
            iq.ctypes.data_as(ctypes.c_void_p), n, int(phase) & 3,
            ctypes.c_float(scale),
            re.ctypes.data_as(ctypes.c_void_p),
            im.ctypes.data_as(ctypes.c_void_p))
        return re, im
    x = iq.astype(np.float32) * scale - 127.5 * scale
    i, q = x[0::2], x[1::2]
    k = (np.arange(n) + phase) % 4
    re = np.where(k == 0, i, np.where(k == 1, -q, np.where(k == 2, -i, q)))
    im = np.where(k == 0, q, np.where(k == 1, i, np.where(k == 2, -q, -i)))
    return re.astype(np.float32), im.astype(np.float32)


def rotate_fs4_u8(iq: np.ndarray, phase: int = 0) -> np.ndarray:
    """fs/4 rotation as a pure byte map (stays u8), on the host.

    Multiplying centered sample x = 2u - 255 by j**(k+phase) only swaps
    and/or negates I/Q, and negation in byte space is the complement
    255 - u — the same trick the reference rotates with on its host
    thread (simple_fm.rs:276-334).  Per complex sample k with
    p = (k + phase) % 4::

        p=0: (I, Q)    p=1: (255-Q, I)    p=2: (255-I, 255-Q)
        p=3: (Q, 255-I)

    Any even byte length.  Native SIMD path with a numpy fallback."""
    iq = np.ascontiguousarray(iq, dtype=np.uint8)
    if iq.size % 2:
        raise ValueError(f"I/Q buffer of {iq.size} bytes is not whole pairs")
    if _native.available():
        out = np.empty_like(iq)
        _lib().tsdr_rotate_fs4_u8(
            iq.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            iq.size // 2, int(phase) & 3)
        return out
    i, q = iq[0::2], iq[1::2]
    p = (np.arange(i.size) + int(phase)) % 4
    out = np.empty_like(iq)
    out[0::2] = np.choose(p, [i, 255 - q, 255 - i, q])
    out[1::2] = np.choose(p, [q, i, 255 - q, 255 - i])
    return out


def f32_to_s16(x: np.ndarray, scale: float = 0.9 * 32767.0) -> np.ndarray:
    """f32 audio -> clamped s16 PCM."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if _native.available():
        out = np.empty(x.size, dtype=np.int16)
        _lib().tsdr_f32_to_s16(
            x.ctypes.data_as(ctypes.c_void_p), x.size, ctypes.c_float(scale),
            out.ctypes.data_as(ctypes.c_void_p))
        return out
    return np.clip(x * scale, -32768, 32767).astype(np.int16)


def count_pattern_breaks(buf: np.ndarray, last: int = -1) -> tuple[int, int]:
    """Count RTL2832U test-pattern counter discontinuities.

    Returns ``(breaks, last_counter)``; feed ``last_counter`` back in for the
    next block (stricter than the reference's rtl_test, which only detects
    short reads, rtl_test.rs:170-181).
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if _native.available():
        c_last = ctypes.c_int(last)
        breaks = _lib().tsdr_count_pattern_breaks(
            buf.ctypes.data_as(ctypes.c_void_p), buf.size, ctypes.byref(c_last))
        return int(breaks), int(c_last.value)
    breaks = 0
    prev = last
    for b in buf.tolist():
        if prev >= 0 and b != (prev + 1) % 256:
            breaks += 1
        prev = b
    return breaks, prev


def parse_tcp_commands(buf: bytes) -> list[tuple[int, int]]:
    """Parse rtl_tcp 5-byte [cmd u8 | param u32-be] records
    (ref rtl_tcp.rs:633-689)."""
    if _native.available():
        n = len(buf) // 5
        cmds = np.empty(n, dtype=np.uint8)
        params = np.empty(n, dtype=np.uint32)
        got = _lib().tsdr_parse_tcp_commands(
            buf, len(buf),
            cmds.ctypes.data_as(ctypes.c_void_p),
            params.ctypes.data_as(ctypes.c_void_p), n)
        return [(int(cmds[i]), int(params[i])) for i in range(got)]
    out = []
    for off in range(0, len(buf) - len(buf) % 5, 5):
        out.append((buf[off], int.from_bytes(buf[off + 1:off + 5], "big")))
    return out
