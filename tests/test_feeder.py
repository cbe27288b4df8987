"""Stream-feeder tests: native pump path, Python fallback, end-to-end with
the rtl_tcp client source (the reference's ingest pipeline analog,
simple_fm.rs:55-132)."""

import os
import tempfile

import numpy as np
import pytest

import tpu_sdr.native as native
from tpu_sdr.stream.feeder import BlockFeeder, BlockSource, FileSource


def _payload(n: int) -> bytes:
    return np.random.default_rng(3).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture
def capture_file():
    data = _payload(8 * 1024)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        f.write(data)
        path = f.name
    yield path, data
    os.unlink(path)


def test_file_feeder_delivers_all_blocks(capture_file):
    path, data = capture_file
    feeder = BlockFeeder(FileSource(path), block_bytes=1024, queue_blocks=4).start()
    got = b"".join(bytes(b) for b in feeder.blocks())
    feeder.stop()
    assert got == data
    assert feeder.dropped == 0


@pytest.mark.skipif(not native.available(), reason="native runtime unavailable")
def test_file_feeder_uses_native_pump(capture_file):
    path, data = capture_file
    feeder = BlockFeeder(FileSource(path), block_bytes=1024, queue_blocks=2).start()
    assert feeder.is_native and feeder._pump is not None
    got = b"".join(bytes(b) for b in feeder.blocks())
    feeder.stop()
    assert got == data  # backpressure, never drops for file replay


def test_python_fallback_matches(capture_file):
    path, data = capture_file
    feeder = BlockFeeder(FileSource(path), block_bytes=1024, native=False).start()
    assert not feeder.is_native
    got = b"".join(bytes(b) for b in feeder.blocks())
    feeder.stop()
    assert got == data


@pytest.mark.skipif(not native.available(), reason="native runtime unavailable")
def test_non_fd_source_routes_through_native_ring():
    class ChunkSource(BlockSource):
        def __init__(self, chunks):
            self.chunks = list(chunks)

        def read_block(self, length):
            return self.chunks.pop(0) if self.chunks else None

    chunks = [bytes([i]) * 256 for i in range(5)]
    feeder = BlockFeeder(ChunkSource(chunks), block_bytes=256, queue_blocks=8).start()
    assert feeder.is_native and feeder._pump is None
    got = [bytes(b) for b in feeder.blocks()]
    feeder.stop()
    assert got == [bytes([i]) * 256 for i in range(5)]


def test_host_fed_harness_transport_path_cpu():
    """The host-fed benchmark harness's plumbing (capture file -> feeder ->
    device_put -> windowed sync) runs end to end on the CPU backend, both
    the transport-only leg and the compute leg; the measurement itself
    needs a GPU."""
    from benchmarks.hostfed import _make_harness

    run, block_bytes, cleanup = _make_harness(block_mb=0.25)
    try:
        assert block_bytes > 0 and block_bytes % (2 * 6 * 85) == 0
        assert run(3, False) > 0
        assert run(3, True) > 0
    finally:
        cleanup()
