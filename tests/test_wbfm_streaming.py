"""Streaming properties of the XLA receive chains: any block split gives the
one-shot audio, the split-bf16 decimator tracks f32, the batched chain
tracks per-station runs, and the wideband streamer serves any station
count."""

import numpy as np
import pytest

from tpu_sdr.models import wbfm, wbfm_batched
from tpu_sdr.models import wbfm_wideband as wb
from tpu_sdr.utils import synth

RATE = 1_020_000


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(262_144, capture_rate=RATE)
    return np.asarray(u8, np.uint8)


def _stream(streamer, buf, cuts):
    edges = [0, *cuts, len(buf)]
    return np.concatenate([streamer.demodulate(buf[a:b])
                           for a, b in zip(edges[:-1], edges[1:])])


@pytest.mark.parametrize("mode,block", [
    ("fir", 262_144), ("fir", 130_560), ("fir", 65_536), ("fir", 12_345),
    ("fir", 1_020), ("boxcar", 130_560),
])
def test_block_size_invariance(capture, mode, block):
    """The reference's 262,144-byte reads, the 130,560-byte chunk, odd
    and quantum-sized blocks: all equal one whole-capture call."""
    config = wbfm.WbfmConfig(filter_mode=mode)
    full = wbfm.WbfmStreamer(config).demodulate(capture)
    cuts = list(range(block, len(capture), block))
    split = _stream(wbfm.WbfmStreamer(config), capture, cuts)
    n = min(len(full), len(split))
    assert n >= len(full) - 32
    np.testing.assert_allclose(split[:n], full[:n], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cuts", [(30_001,), (7, 130_561, 200_003)])
def test_unaligned_pending_buffer(capture, cuts):
    """Splits off every quantum boundary, odd byte counts included, go
    through the pending buffer without losing or repeating a sample."""
    config = wbfm.WbfmConfig(filter_mode="fir")
    full = wbfm.WbfmStreamer(config).demodulate(capture)
    split = _stream(wbfm.WbfmStreamer(config), capture, list(cuts))
    n = min(len(full), len(split))
    np.testing.assert_allclose(split[:n], full[:n], rtol=1e-5, atol=1e-6)
    snr = synth.tone_snr(split.astype(np.float64), 1_000.0, 32_000, skip=1500)
    assert snr >= 45.0, f"{snr:.1f} dB"


@pytest.mark.parametrize("audio_freq", [400.0, 1_000.0, 5_000.0])
def test_split_bf16_tracks_f32(audio_freq):
    u8, _ = synth.synth_wbfm_u8(130_560, capture_rate=RATE,
                                audio_freq=audio_freq)
    u8 = np.asarray(u8, np.uint8)
    f32 = wbfm.WbfmStreamer(wbfm.WbfmConfig(mxu_precision="f32")
                            ).demodulate(u8)
    bf16 = wbfm.WbfmStreamer(wbfm.WbfmConfig(mxu_precision="split_bf16")
                             ).demodulate(u8)
    err = bf16 - f32
    snr = 10 * np.log10(np.mean(f32 ** 2) / max(np.mean(err ** 2), 1e-30))
    assert snr >= 80.0, f"split-bf16 vs f32 at {audio_freq} Hz: {snr:.1f} dB"


@pytest.mark.parametrize("stations", [1, 3, 8])
def test_batched_matches_per_station(stations):
    config = wbfm.WbfmConfig(filter_mode="fir")
    n_bytes = 2 * 6 * 85 * 64
    blocks = np.stack([
        synth.synth_wbfm_u8(n_bytes, capture_rate=RATE,
                            audio_freq=300.0 * (i + 1), seed=i)[0]
        for i in range(stations)])
    batch = wbfm_batched.WbfmBatchStreamer(stations, config)
    got = [batch.demodulate(blocks[:, :n_bytes]),
           batch.demodulate(blocks[:, n_bytes:])]
    for i in range(stations):
        s = wbfm.WbfmStreamer(config)
        for k, part in enumerate((blocks[i, :n_bytes], blocks[i, n_bytes:])):
            np.testing.assert_allclose(got[k][i], s.demodulate(part),
                                       atol=2e-5)


@pytest.mark.parametrize("n_stations", [1, 2, 8])
def test_wideband_station_counts(n_stations):
    K = 16
    channels = tuple(range(1, 2 * n_stations, 2))  # odd channels: no neighbours
    config = wb.WidebandConfig(num_channels=K, channels=channels)
    freqs = [(k if k <= K // 2 else k - K) * config.channel_rate
             for k in channels]
    tones = [500.0 + 350.0 * i for i in range(n_stations)]
    n = 4 * K * config.resample_down * 32
    u8, _ = synth.synth_multistation_u8(n, config.capture_rate, freqs, tones,
                                        deviation=45_000.0)
    u8 = np.asarray(u8, np.uint8)
    full = wb.WidebandStreamer(config).demodulate(u8)
    assert full.shape[0] == n_stations
    two = wb.WidebandStreamer(config)
    cut = len(u8) // 3 + 1
    split = np.concatenate([two.demodulate(u8[:cut]),
                            two.demodulate(u8[cut:])], axis=1)
    m = min(full.shape[1], split.shape[1])
    np.testing.assert_allclose(split[:, :m], full[:, :m], rtol=1e-4,
                               atol=1e-5)
    for s, f in enumerate(tones):
        snr = synth.tone_snr(full[s], f, config.rate_resample, skip=400)
        assert snr >= 25.0, f"station {s} ({channels[s]}): {snr:.1f} dB"
