"""Native host-runtime tests: ring buffer, fd pump, byte-path conversions.

The conversions are checked against independent numpy oracles (and against
the JAX ops where they overlap); the ring is checked for FIFO order,
backpressure drops, and EOF draining — the semantics of the reference's
bounded channels (rtl_tcp.rs:24,365; simple_fm.rs:55-63).
"""

import os
import tempfile
import threading

import numpy as np
import pytest

import tpu_sdr.native as native
from tpu_sdr.native import (
    NativePump,
    NativeRing,
    count_pattern_breaks,
    f32_to_s16,
    parse_tcp_commands,
    u8_iq_to_planar_f32,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_ring_fifo_and_count():
    ring = NativeRing(block_bytes=8, capacity=4)
    assert ring.push(bytes(range(8)))
    assert ring.push(bytes(range(8, 16)))
    assert len(ring) == 2
    a = ring.pop(timeout_ms=1000)
    b = ring.pop(timeout_ms=1000)
    assert list(a) == list(range(8))
    assert list(b) == list(range(8, 16))
    assert len(ring) == 0
    ring.close()


def test_ring_backpressure_drops():
    ring = NativeRing(block_bytes=4, capacity=2)
    assert ring.push(b"aaaa")
    assert ring.push(b"bbbb")
    assert not ring.push(b"cccc")  # full -> dropped
    assert ring.dropped == 1
    assert bytes(ring.pop()) == b"aaaa"
    assert ring.push(b"dddd")  # slot freed
    ring.close()


def test_ring_pop_timeout_and_eof():
    ring = NativeRing(block_bytes=4, capacity=2)
    with pytest.raises(TimeoutError):
        ring.pop(timeout_ms=10)
    ring.push(b"xxxx")
    ring.set_eof()
    assert bytes(ring.pop()) == b"xxxx"  # drains before EOF
    assert ring.pop(timeout_ms=1000) is None
    ring.close()


def test_ring_blocking_pop_cross_thread():
    ring = NativeRing(block_bytes=4, capacity=2)
    got = []

    def consumer():
        got.append(bytes(ring.pop(timeout_ms=5000)))

    t = threading.Thread(target=consumer)
    t.start()
    ring.push(b"late")
    t.join(timeout=5)
    assert got == [b"late"]
    ring.close()


def test_pump_reads_file_blocks():
    payload = bytes(range(256)) * 4  # 1024 bytes = 8 x 128B blocks
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(payload)
        path = f.name
    try:
        ring = NativeRing(block_bytes=128, capacity=16)
        fd = os.open(path, os.O_RDONLY)
        pump = NativePump(ring, fd, loop_file=False)
        blocks = []
        while True:
            blk = ring.pop(timeout_ms=5000)
            if blk is None:
                break
            blocks.append(bytes(blk))
        pump.stop()
        os.close(fd)
        assert b"".join(blocks) == payload
        ring.close()
    finally:
        os.unlink(path)


def test_pump_loop_mode_replays():
    payload = bytes(range(64))
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(payload)
        path = f.name
    try:
        ring = NativeRing(block_bytes=32, capacity=8)
        fd = os.open(path, os.O_RDONLY)
        pump = NativePump(ring, fd, loop_file=True, block_on_full=True)
        blocks = [bytes(ring.pop(timeout_ms=5000)) for _ in range(6)]
        pump.stop()
        os.close(fd)
        ring.close()
        assert b"".join(blocks) == payload * 3
    finally:
        os.unlink(path)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_u8_iq_conversion_matches_jax_ops(phase):
    import jax.numpy as jnp

    from tpu_sdr.ops import fm as F

    rng = np.random.default_rng(7)
    buf = rng.integers(0, 256, size=512, dtype=np.uint8)
    re_n, im_n = u8_iq_to_planar_f32(buf, phase=phase)
    re_j, im_j = F.u8_to_f32(jnp.asarray(buf))
    re_j, im_j, _ = F.rotate_fs4(re_j, im_j, F.RotatorState(jnp.int32(phase)))
    np.testing.assert_allclose(re_n, np.asarray(re_j), atol=1e-6)
    np.testing.assert_allclose(im_n, np.asarray(im_j), atol=1e-6)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_rotate_fs4_u8_native_matches_numpy(phase, monkeypatch):
    """The native byte-map rotation must equal the numpy fallback, and
    decoding its output as centered floats must equal the f32 rotation."""
    from tpu_sdr.native import rotate_fs4_u8

    rng = np.random.default_rng(11)
    buf = rng.integers(0, 256, size=1024, dtype=np.uint8)
    got = rotate_fs4_u8(buf, phase=phase)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        np.testing.assert_array_equal(got, rotate_fs4_u8(buf, phase=phase))
    if phase == 0:  # the reference's own 8-byte pattern
        import jax.numpy as jnp

        from tpu_sdr.ops.exact import rotate_90_u8

        np.testing.assert_array_equal(
            got, np.asarray(rotate_90_u8(jnp.asarray(buf))))

    # centered decode of the rotated bytes == rotation of the centered decode
    re_n, im_n = u8_iq_to_planar_f32(buf, phase=phase, scale=2.0)  # x255 scale
    x = got.astype(np.float32) * 2.0 - 255.0
    np.testing.assert_allclose(x[0::2], re_n, atol=1e-5)
    np.testing.assert_allclose(x[1::2], im_n, atol=1e-5)


def test_f32_to_s16_clamps():
    x = np.array([0.0, 0.5, -0.5, 2.0, -2.0], dtype=np.float32)
    out = f32_to_s16(x, scale=32767.0)
    assert out[0] == 0
    assert out[3] == 32767 and out[4] == -32768
    assert abs(int(out[1]) - 16383) <= 1 and abs(int(out[2]) + 16383) <= 1


def test_count_pattern_breaks_wraps_and_carries():
    clean = np.arange(300, dtype=np.uint32).astype(np.uint8)  # wraps at 256
    breaks, last = count_pattern_breaks(clean)
    assert breaks == 0 and last == clean[-1]
    # continuity across blocks
    b2 = ((np.arange(10) + last + 1) % 256).astype(np.uint8)
    breaks, last = count_pattern_breaks(b2, last)
    assert breaks == 0
    # a dropped byte is one discontinuity
    broken = np.array([1, 2, 4, 5], dtype=np.uint8)
    breaks, _ = count_pattern_breaks(broken)
    assert breaks == 1


def test_parse_tcp_commands_matches_python():
    buf = bytes([0x01, 0x05, 0xF5, 0xE1, 0x00,   # SetFrequency 100M
                 0x04, 0x00, 0x00, 0x01, 0x2C,   # SetGain 300
                 0x07])                           # trailing partial -> ignored
    cmds = parse_tcp_commands(buf)
    assert cmds == [(0x01, 100_000_000), (0x04, 300)]


def test_pump_tolerates_nonblocking_fd():
    """Python socket timeouts set O_NONBLOCK; the pump must poll, not EOF."""
    import socket

    a, b = socket.socketpair()
    a.settimeout(2.0)  # makes fd non-blocking
    ring = NativeRing(block_bytes=64, capacity=4)
    pump = NativePump(ring, a.fileno(), loop_file=False)
    time_payload = bytes(range(64))
    import time as _t

    _t.sleep(0.15)  # pump hits EAGAIN repeatedly before data arrives
    b.sendall(time_payload)
    blk = ring.pop(timeout_ms=5000)
    assert bytes(blk) == time_payload
    pump.stop()
    a.close()
    b.close()
    ring.close()


def test_ring_concurrent_stress():
    """Producer/consumer hammer: every block delivered exactly once, in
    order, under concurrency (the ring is the serving path's only shared
    mutable state — the framework's race-safety hinges on it)."""
    ring = NativeRing(block_bytes=16, capacity=8)
    n_blocks = 2000
    got = []

    def producer():
        for i in range(n_blocks):
            payload = i.to_bytes(4, "little") * 4
            while not ring.push(payload):
                pass  # full: spin until the consumer frees a slot
        ring.set_eof()

    def consumer():
        while True:
            blk = ring.pop(timeout_ms=10_000)
            if blk is None:
                return
            got.append(int.from_bytes(bytes(blk[:4]), "little"))

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t1.start(); t2.start()
    t1.join(timeout=30); t2.join(timeout=30)
    assert got == list(range(n_blocks))
    ring.close()
