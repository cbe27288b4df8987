"""Full production stack, end to end: simulated dongle broadcasting a
synthesized WBFM station -> rtl_tcp server (native ring) -> protocol client
over a real socket -> native feeder pump -> streaming receive chain ->
audio tone SNR.  This is the reference's whole usage story
(rtl_tcp + a downstream demodulator) in one test."""

import threading
import time

import numpy as np
import pytest

from tpu_sdr import DEFAULT_BUF_LENGTH, api
from tpu_sdr.control import fake
from tpu_sdr.models import wbfm
from tpu_sdr.stream.feeder import BlockFeeder, RtlTcpClientSource
from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer
from tpu_sdr.utils import synth

CAPTURE_RATE = 1_020_000


@pytest.fixture
def radio_stack():
    fake.clear_fake_devices()
    # the simulated dongle "receives" a clean 1 kHz WBFM tone off-air
    fake.register_fake_device(fake.FakeDeviceSpec(
        source_factory=lambda: fake.SynthFmSource(
            capture_rate=CAPTURE_RATE, audio_freq=1_000.0, noise_std=0.0)))
    sdr = api.RtlSdr.open_with_index(0)
    sdr.set_sample_rate(CAPTURE_RATE)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=64)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    while srv.bound_port is None:
        time.sleep(0.01)
    yield srv
    srv.stop()
    t.join(timeout=5)
    sdr.close()
    fake.clear_fake_devices()


def test_radio_to_audio_over_tcp(radio_stack):
    srv = radio_stack
    src = RtlTcpClientSource("127.0.0.1", srv.bound_port)
    assert src.tuner_type == 5  # R820T

    feeder = BlockFeeder(src, block_bytes=DEFAULT_BUF_LENGTH,
                         queue_blocks=8).start()
    streamer = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir"))

    audio = []
    for i, block in enumerate(feeder.blocks()):
        audio.append(streamer.demodulate(block))
        if i >= 3:
            break
    feeder.stop()

    out = np.concatenate(audio)
    # 4 reads of 131,072 samples at 1.02 Msps -> 32 kHz, less the pending
    # residual of the last read
    assert out.size >= 4 * (DEFAULT_BUF_LENGTH // 2) * 32 // 1020 - 32
    snr = synth.tone_snr(out.astype(np.float64), 1_000.0, 32_000, skip=400)
    assert snr >= 40.0, f"end-to-end tone SNR {snr:.1f} dB"
