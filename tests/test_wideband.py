"""Wideband multi-station receive: synthesize several WBFM stations in one
capture, channelize, demodulate all of them in parallel, and score each
recovered tone (the reference can only do one station per process)."""

import numpy as np
import pytest

from tpu_sdr.models import wbfm_wideband as wb
from tpu_sdr.utils import synth


@pytest.fixture(scope="module")
def received():
    config = wb.WidebandConfig(num_channels=64, channels=(3, 60))
    fs = config.capture_rate  # 10.88 Msps
    ch_rate = config.channel_rate
    # stations at channel 3 (+3*170k) and channel 60 (-4*170k)
    n = 8 * 64 * 85 * 4  # multiple of K*down
    u8, audios = synth.synth_multistation_u8(
        n, fs, station_freqs=[3 * ch_rate, -4 * ch_rate],
        audio_freqs=[1_000.0, 2_500.0], deviation=45_000.0)
    streamer = wb.WidebandStreamer(config)
    audio = streamer.demodulate(u8)
    return config, audio


def test_both_stations_recovered(received):
    config, audio = received
    assert audio.shape[0] == 2
    snr0 = synth.tone_snr(audio[0], 1_000.0, config.rate_resample, skip=400)
    snr1 = synth.tone_snr(audio[1], 2_500.0, config.rate_resample, skip=400)
    assert snr0 >= 25.0, f"station 0 tone SNR {snr0:.1f} dB"
    assert snr1 >= 25.0, f"station 1 tone SNR {snr1:.1f} dB"


def test_stations_do_not_leak(received):
    """Station 1's tone must not appear in station 0's audio (adjacent
    channel isolation through the PFB)."""
    config, audio = received
    leak = synth.tone_snr(audio[0], 2_500.0, config.rate_resample, skip=400)
    want = synth.tone_snr(audio[0], 1_000.0, config.rate_resample, skip=400)
    assert want - leak >= 20.0, f"crosstalk too high: {want:.1f} vs {leak:.1f}"


def test_streaming_invariance():
    config = wb.WidebandConfig(num_channels=64, channels=(5,))
    n = 4 * 64 * 85 * 2
    u8, _ = synth.synth_multistation_u8(
        n, config.capture_rate, station_freqs=[5 * config.channel_rate],
        audio_freqs=[800.0], deviation=40_000.0)
    one = wb.WidebandStreamer(config)
    full = one.demodulate(u8)
    two = wb.WidebandStreamer(config)
    cut = len(u8) // 2
    split = np.concatenate(
        [two.demodulate(u8[:cut]), two.demodulate(u8[cut:])], axis=1)
    np.testing.assert_allclose(split, full, rtol=1e-4, atol=1e-5)
