"""End-to-end checks of the receive chain on one target device.

Each phase drives one user path through its normal entry points (the
``simple_fm`` demodulators, the feeder, the rtl_tcp server, the wideband
streamer with RDS, the stereo decoder, the ``rtl_power`` PSD, the block
transform) on a target device, and compares what comes out with the
repository's plain reference: the reference's golden vectors and integer
oracle, the same chain run on the CPU in the same process, or the known
signal the input was synthesized from.  A phase returns its
:class:`Check` list; it passes when every check holds.

``chip_smoke.py`` runs the phases at full width on a GPU; the tests run them
at :data:`TINY` sizes on the CPU (tests/test_chip_smoke.py) and at full
width in the ``gpu`` tier (tests/test_gpu.py).
"""

from __future__ import annotations

import math
import os
import re
import tempfile
import threading
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr import DEFAULT_BUF_LENGTH
from tpu_sdr.utils import synth

FM_RATE = 1_020_000      # one dongle, reference simple_fm (src/lib.rs:25)
AUDIO_RATE = 32_000
PSD_RATE = 2_048_000     # rtl_power's default sample rate
# Fidelity bound of the product (BASELINE.md): a float chain on the
# accelerator must agree with the same chain on the CPU, and the float
# boxcar twin with the exact integer chain, to at least this.
FIDELITY_DB = 60.0


@dataclass(frozen=True)
class Sizes:
    """Workload sizes.  The defaults are the deployments' own widths."""

    fm_seconds: float = 10.0           # simple_fm capture at 1.02 Msps
    tcp_blocks: int = 12               # 262,144-byte blocks over rtl_tcp
    wide_channels: int = 64            # multi_fm default: 64 x 170 kHz
    wide_stations: tuple[int, ...] = (3, 17, 40, 60)
    rds_repeats: int = 4               # PS cycles in each RDS stream
    psd_step_hz: int = 1_000           # rtl_power bin width -> FFT size
    psd_blocks: int = 16
    large_complex: int = 6 * 85 * 24576  # 12.5M complex samples (25 MB u8)
    large_iters: int = 10
    shard_complex: int = 6 * 85 * 4096   # complex samples per time shard
    shard_channels: int = 64


TINY = Sizes(fm_seconds=0.3, tcp_blocks=4, wide_channels=8,
             wide_stations=(1, 3, 5, 7), psd_step_hz=8_000, psd_blocks=2,
             large_complex=6 * 85 * 256, large_iters=1,
             shard_complex=6 * 85 * 4, shard_channels=16)


@dataclass(frozen=True)
class Check:
    """``value <op> limit``; the comparison and its tolerance, printable."""

    name: str
    value: float
    op: str
    limit: float
    unit: str = "dB"

    @property
    def ok(self) -> bool:
        v, lim = self.value, self.limit
        return {">": v > lim, ">=": v >= lim, "<=": v <= lim,
                "==": v == lim}[self.op]

    def __str__(self) -> str:
        u = f" {self.unit}" if self.unit else ""
        return (f"{self.name} {self.value:.6g}{u} "
                f"({self.op} {self.limit:g}{u}) {'ok' if self.ok else 'FAIL'}")


@dataclass
class PhaseResult:
    name: str
    checks: list[Check]
    precision: str
    info: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def err_db(ref, got) -> float:
    """10 log10(|ref|^2 / |got - ref|^2) over the common length, in dB;
    inf when identical."""
    n = min(len(ref), len(got))
    r = np.asarray(ref[:n], np.float64)
    e = np.asarray(got[:n], np.float64) - r
    p_err = float(np.dot(e.ravel(), e.ravel()))
    if p_err == 0.0:
        return math.inf
    return float(10 * np.log10(float(np.dot(r.ravel(), r.ravel())) / p_err))


def _precision(**ops: str) -> str:
    default = jax.config.jax_default_matmul_precision or "unset"
    return " ".join([f"{k}={v}" for k, v in ops.items()]
                    + [f"jax_default_matmul_precision={default}"])


FIR_PRECISION = dict(decimator="split_bf16(bf16 x2, f32 acc)",
                     resampler="HIGH")


def _on(x, device) -> None:
    """Fail loudly if an output did not come from ``device``."""
    got = set(x.devices())
    if got != {device}:
        raise RuntimeError(f"ran on {got}, expected {device}")


# ---------------------------------------------------------------------------
# Phase 0: what the card's matmul precisions lower to
# ---------------------------------------------------------------------------

def precision_probe(device, n: int = 512) -> PhaseResult:
    """Relative error of an f32 matmul at each ``lax.Precision`` against
    float64, and the dot algorithms named in the compiled HLO.  Class by
    error: < 1e-5 f32-class, < 1e-3 tf32-class, else bf16-class."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    da, db = jax.device_put(a, device), jax.device_put(b, device)
    checks, info = [], []
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        f = jax.jit(lambda x, y, p=prec: jnp.dot(x, y, precision=p))
        got = f(da, db)
        _on(got, device)
        rel = float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                    / np.linalg.norm(ref))
        cls = ("f32-class" if rel < 1e-5 else
               "tf32-class" if rel < 1e-3 else "bf16-class")
        hlo = f.lower(da, db).compile().as_text() or ""
        algos = sorted(set(re.findall(r"ALG_[A-Z0-9_]+|algorithm=\w+|tf32",
                                      hlo, flags=re.IGNORECASE)))
        info.append(f"{name}: rel err {rel:.3g} -> {cls}; "
                    f"hlo {', '.join(algos) or 'no algorithm named'}")
        checks.append(Check(f"{name} matmul rel err", rel, "<=", 1e-2, ""))
    return PhaseResult("precision", checks, _precision(), info)


# ---------------------------------------------------------------------------
# Phase 1: golden conformance of the integer chain
# ---------------------------------------------------------------------------

def golden(device, ref_device=None, sizes: Sizes = Sizes()) -> PhaseResult:
    """The exact integer chain against the reference's embedded ``rtl_fm``
    vectors, stage by stage, and the composed streamer against the
    plain-Python reference loop.  Every lane bit-exact except each block's
    first discriminator sample, which uses the exact atan2: f64 in the
    reference, f32 without x64, so it may differ by <= 1 LSB of the
    pi == 2^14 scale (and so may the audio it feeds)."""
    from tpu_sdr.models import wbfm_exact
    from tpu_sdr.ops import exact
    from tpu_sdr.utils import golden as G

    def pairs(v):
        a = np.asarray(v, np.int32)
        return a[0::2], a[1::2]

    def mismatches(got, exp) -> int:
        got, exp = np.asarray(got), np.asarray(exp)
        if got.shape != exp.shape:
            return max(len(got), len(exp))
        return int(np.sum(got != exp))

    checks = []
    with jax.default_device(device):
        re_, im_ = pairs(G.BUF_SIGNED)
        o_re, o_im, count, _ = exact.boxcar_decimate(
            jnp.asarray(re_), jnp.asarray(im_), exact.boxcar_init(), 6)
        _on(o_re, device)
        count = int(count)
        e_re, e_im = pairs(G.LOWPASS)
        checks.append(Check("lowpass mismatches", mismatches(
            np.concatenate([np.asarray(o_re)[:count], np.asarray(o_im)[:count]]),
            np.concatenate([e_re, e_im])), "==", 0, ""))

        l_re, l_im = pairs(G.LOWPASS)
        out, count, _ = exact.fm_discriminate(
            jnp.asarray(l_re), jnp.asarray(l_im), jnp.int32(len(l_re)),
            exact.discriminator_init())
        got = np.asarray(out)[: int(count)].astype(np.int32)
        exp = np.asarray(G.DEMOD_EXPECTED, np.int32)
        checks.append(Check("demod fast-atan2 lane mismatches",
                            mismatches(got[1:], exp[1:]), "==", 0, ""))
        checks.append(Check("demod exact-atan2 lane |diff|",
                            abs(int(got[0]) - int(exp[0])), "<=", 1, "LSB"))

        out, count, _ = exact.boxcar_resample(
            jnp.asarray(G.DEMOD_EXPECTED, dtype=jnp.int16),
            jnp.int32(len(G.DEMOD_EXPECTED)), exact.resampler_init(),
            rate_out=170_000, rate_resample=AUDIO_RATE)
        checks.append(Check("resampler mismatches", mismatches(
            np.asarray(out)[: int(count)], G.RESULT), "==", 0, ""))

        rng = np.random.default_rng(3)
        edge = np.array([0, 1, -1, (1 << 31) - 1, -(1 << 31), 1 << 20,
                         -(1 << 20), 12345, -98765])
        small = rng.integers(-(1 << 15), 1 << 15, 256)
        big = rng.integers(-(1 << 30), 1 << 30, 256)
        ys = np.concatenate([small, big, edge, edge[::-1]]).astype(np.int32)
        xs = np.concatenate([big, small, edge[::-1], edge]).astype(np.int32)
        got = np.asarray(exact.fast_atan2_i32(jnp.asarray(ys), jnp.asarray(xs)))
        exp = [G.fast_atan2_i32_oracle(int(y), int(x)) for y, x in zip(ys, xs)]
        checks.append(Check("fast_atan2 i32-wrap mismatches",
                            mismatches(got, np.asarray(exp, np.int32)),
                            "==", 0, ""))

        blocks = [rng.integers(0, 256, 1024, dtype=np.uint8) for _ in range(4)]
        streamer = wbfm_exact.WbfmExactStreamer()
        got = np.concatenate([streamer.demodulate(b) for b in blocks])
    want = G.oracle_demodulate(blocks)
    if got.shape != want.shape:
        raise RuntimeError(f"exact chain shape {got.shape} != {want.shape}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    checks.append(Check("full chain vs oracle max |diff|", int(diff.max()),
                        "<=", 1, "LSB"))
    checks.append(Check("full chain bit-exact share",
                        float((diff == 0).mean()), ">=", 0.9, ""))
    return PhaseResult("golden", checks, _precision(chain="int32, no matmul"))


# ---------------------------------------------------------------------------
# Phase 2: simple_fm demodulators fed through the block feeder
# ---------------------------------------------------------------------------

def _feeder_blocks(u8: np.ndarray) -> tuple[list[np.ndarray], int]:
    """Stream a capture from a file through ``BlockFeeder`` in the
    reference's 262,144-byte reads; returns (blocks, dropped)."""
    from tpu_sdr.stream.feeder import BlockFeeder, FileSource

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.u8")
        u8.tofile(path)
        feeder = BlockFeeder(FileSource(path), block_bytes=DEFAULT_BUF_LENGTH,
                             queue_blocks=16).start()
        try:
            blocks = [np.array(b, copy=True) for b in feeder.blocks()]
        finally:
            feeder.stop()
        return blocks, feeder.dropped


def _run_demod(mode: str, blocks, device) -> tuple[np.ndarray, list[float]]:
    """simple_fm's demodulator for ``mode`` over ``blocks`` on ``device``:
    (s16 audio, per-block wall seconds)."""
    from tpu_sdr.apps.simple_fm import make_demodulator

    with jax.default_device(device):
        demod, _ = make_demodulator(mode)
        parts, secs = [], []
        for b in blocks:
            t0 = time.perf_counter()
            parts.append(demod(b))
            secs.append(time.perf_counter() - t0)
    return np.concatenate(parts).astype(np.float64), secs


def simple_fm(device, ref_device, sizes: Sizes = Sizes()) -> PhaseResult:
    """``make_demodulator('fir'|'boxcar'|'exact')`` over a synthesized
    1 kHz WBFM capture read through the feeder: fir tone SNR > 45 dB
    (8-bit input quantization caps it near 57), boxcar >= 60 dB against
    the exact chain, and both float chains against their CPU run."""
    n = int(sizes.fm_seconds * FM_RATE)
    n -= n % (DEFAULT_BUF_LENGTH // 2)
    u8, _ = synth.synth_wbfm_u8(max(n, DEFAULT_BUF_LENGTH // 2),
                                capture_rate=FM_RATE)
    blocks, dropped = _feeder_blocks(np.asarray(u8, np.uint8))
    out, secs = {}, {}
    for mode in ("fir", "boxcar", "exact"):
        out[mode], secs[mode] = _run_demod(mode, blocks, device)
    ref = {m: _run_demod(m, blocks, ref_device)[0] for m in ("fir", "boxcar")}
    box_snr, lag = synth.align_and_snr(out["exact"], out["boxcar"],
                                       max_lag=4, skip=50)
    checks = [
        Check("feeder blocks dropped", dropped, "==", 0, ""),
        Check("fir tone SNR", synth.tone_snr(out["fir"], 1_000.0, AUDIO_RATE,
                                             skip=1500), ">", 45.0),
        Check("fir GPU vs CPU", err_db(ref["fir"], out["fir"]), ">=",
              FIDELITY_DB),
        Check("boxcar vs exact", box_snr, ">=", FIDELITY_DB),
        Check("boxcar vs exact lag", lag, "==", 0, "samples"),
        Check("boxcar GPU vs CPU", err_db(ref["boxcar"], out["boxcar"]), ">=",
              FIDELITY_DB),
    ]
    info = [f"{len(blocks)} blocks of {DEFAULT_BUF_LENGTH} B "
            f"({len(blocks) * DEFAULT_BUF_LENGTH / 2 / FM_RATE:.2f} s of air)"]
    for mode, s in secs.items():
        warm = s[3:] or s
        info.append(f"{mode}: median {1e3 * float(np.median(warm)):.3f} ms "
                    f"per block, host wall clock incl. transfers")
    return PhaseResult("simple_fm", checks, _precision(**FIR_PRECISION), info)


# ---------------------------------------------------------------------------
# Phase 3: the served path, fake dongle -> rtl_tcp -> feeder -> device
# ---------------------------------------------------------------------------

def rtl_tcp(device, ref_device=None, sizes: Sizes = Sizes()) -> PhaseResult:
    """A fake dongle synthesizing a 1 kHz WBFM station behind the rtl_tcp
    server on 127.0.0.1, read by the protocol client through the feeder
    and demodulated on ``device``.  The source loops a 1 s capture, whose
    seam clicks once a second, hence the 20 dB bound of the CLI test."""
    from tpu_sdr import api
    from tpu_sdr.apps.simple_fm import make_demodulator
    from tpu_sdr.control import fake
    from tpu_sdr.stream.feeder import BlockFeeder, RtlTcpClientSource
    from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="smoke001",
        source_factory=lambda: fake.SynthFmSource(capture_rate=FM_RATE)))
    sdr = api.RtlSdr.open_with_index(0)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=64)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        deadline = time.time() + 10
        while srv.bound_port is None and time.time() < deadline:
            time.sleep(0.01)
        if srv.bound_port is None:
            raise RuntimeError("rtl_tcp server did not bind")
        src = RtlTcpClientSource("127.0.0.1", srv.bound_port)
        tuner = src.tuner_type
        src.set_sample_rate(FM_RATE)
        src.set_gain_mode(False)
        feeder = BlockFeeder(src, block_bytes=DEFAULT_BUF_LENGTH,
                             queue_blocks=16).start()
        parts = []
        try:
            with jax.default_device(device):
                demod, _ = make_demodulator("fir")
                for blk in feeder.blocks():
                    parts.append(demod(blk))
                    if len(parts) >= sizes.tcp_blocks:
                        break
        finally:
            feeder.stop()
    finally:
        srv.stop()
        t.join(timeout=5)
        sdr.close()
        fake.clear_fake_devices()
    audio = np.concatenate(parts).astype(np.float64)
    checks = [
        Check("handshake tuner type (R820T)", tuner, "==", 5, ""),
        Check("blocks received", len(parts), "==", sizes.tcp_blocks, ""),
        Check("tone SNR over rtl_tcp", synth.tone_snr(
            audio, 1_000.0, AUDIO_RATE, skip=4000), ">", 20.0),
    ]
    return PhaseResult("rtl_tcp", checks, _precision(**FIR_PRECISION))


# ---------------------------------------------------------------------------
# Phase 4: wideband capture, channelized, RDS on every station
# ---------------------------------------------------------------------------

def _rds_bits(pi: int, ps: str, repeats: int) -> np.ndarray:
    from tpu_sdr.models import rds

    groups = [rds.make_group_0a(pi, 10, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    return np.concatenate([np.concatenate(groups)] * repeats)


def _rds_samples(bits: np.ndarray, rate: float, quantum: int) -> int:
    """Capture length covering ``bits`` plus lock slack, rounded up to a
    whole number of ``quantum`` samples."""
    n = int(np.ceil((len(bits) + 120) / 1187.5 * rate))
    return -(-n // quantum) * quantum


def _run_wideband(config, blocks, device, rds_config=None):
    """WidebandStreamer over ``blocks`` on ``device``: per-station audio,
    and the RDS text events per station when ``rds_config`` is given."""
    from tpu_sdr.models import rds
    from tpu_sdr.models import wbfm_wideband as wb

    n_st = len(config.channels)
    with jax.default_device(device):
        streamer = wb.WidebandStreamer(config)
        decoders = ([rds.RdsStreamDecoder(rds_config) for _ in range(n_st)]
                    if rds_config is not None else None)
        events = [[] for _ in range(n_st)]
        parts = []
        for blk in blocks:
            parts.append(streamer.demodulate(blk))
            if decoders is not None:
                for s, dec in enumerate(decoders):
                    events[s].extend(dec.feed_mpx(streamer.last_mpx[s]))
    return np.concatenate(parts, axis=1).astype(np.float64), events


def wideband(device, ref_device, sizes: Sizes = Sizes()) -> PhaseResult:
    """multi_fm's receiver at 64 x 170 kHz = 10.88 Msps with four stations,
    each with its own tone, pilot and RDS stream: every tone recovered
    (>= 25 dB), no tone leaking into another station's channel (>= 20 dB
    below the station's own), every PS name decoded, and the audio against
    the CPU run."""
    from tpu_sdr.models import rds
    from tpu_sdr.models import wbfm_wideband as wb

    K = sizes.wide_channels
    stations = tuple(sizes.wide_stations)
    config = wb.WidebandConfig(num_channels=K, channels=stations,
                               emit_mpx=True)
    tones = [900.0, 1_500.0, 2_300.0, 3_100.0, 3_700.0, 4_300.0][:len(stations)]
    names = [f"SMOKE{k:03d}" for k in stations]
    bits = [_rds_bits(0xC100 + i, names[i], sizes.rds_repeats)
            for i in range(len(stations))]
    block_complex = 64 * K * config.resample_down   # multi_fm's read size
    n = _rds_samples(bits[0], config.capture_rate, block_complex)
    freqs = [(k if k <= K // 2 else k - K) * config.channel_rate
             for k in stations]
    u8, _ = synth.synth_multistation_u8(
        n, config.capture_rate, station_freqs=freqs, audio_freqs=tones,
        deviation=60_000.0, rds_bits=bits)
    u8 = np.asarray(u8, np.uint8)
    blocks = [u8[i:i + 2 * block_complex]
              for i in range(0, len(u8), 2 * block_complex)]
    audio, events = _run_wideband(config, blocks, device, rds.RdsConfig())
    ref_audio, _ = _run_wideband(config, blocks, ref_device)
    checks = []
    for s, k in enumerate(stations):
        snrs = [synth.tone_snr(audio[s], f, AUDIO_RATE, skip=400)
                for f in tones]
        own = snrs[s]
        leak = max(v for i, v in enumerate(snrs) if i != s)
        checks.append(Check(f"ch{k} tone SNR", own, ">=", 25.0))
        checks.append(Check(f"ch{k} own tone over strongest other", own - leak,
                            ">=", 20.0))
        checks.append(Check(f"ch{k} PS '{names[s]}' decoded",
                            float(f"PS: '{names[s]}'" in events[s]), "==", 1.0,
                            ""))
    checks.append(Check("audio GPU vs CPU", err_db(ref_audio.ravel(),
                                                   audio.ravel()),
                        ">=", FIDELITY_DB))
    info = [f"{n / config.capture_rate:.2f} s at "
            f"{config.capture_rate / 1e6:.2f} Msps, {len(blocks)} blocks"]
    return PhaseResult("wideband", checks, _precision(
        pfb="HIGHEST", resampler="HIGH", rds_fir="HIGHEST",
        rds_resampler="HIGHEST"), info)


# ---------------------------------------------------------------------------
# Phase 5: stereo + RDS from one multiplex
# ---------------------------------------------------------------------------

def _run_stereo(blocks, device, with_rds: bool):
    from tpu_sdr.models import rds
    from tpu_sdr.models.wbfm_stereo import StereoConfig, WbfmStereoStreamer

    config = StereoConfig(emit_mpx=with_rds)
    with jax.default_device(device):
        st = WbfmStereoStreamer(config)
        dec = (rds.RdsStreamDecoder(rds.RdsConfig.for_mpx_rate(
            config.base.rate_out)) if with_rds else None)
        parts, events = [], []
        for b in blocks:
            parts.append(st.demodulate(b))
            if dec is not None:
                events.extend(dec.feed_mpx(st.last_mpx))
    return np.concatenate(parts, axis=1).astype(np.float64), events


def stereo(device, ref_device, sizes: Sizes = Sizes()) -> PhaseResult:
    """``simple_fm --mode stereo --rds``: L carries 800 Hz, R 1300 Hz; each
    channel's own tone > 30 dB (the CLI test's bound on an RDS-bearing
    capture), the PS name decoded, and the audio against the CPU run."""
    pi, ps = 0xD00D, "STEREO+R"
    bits = _rds_bits(pi, ps, sizes.rds_repeats)
    n = _rds_samples(bits, FM_RATE, 6 * 85)
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=FM_RATE,
                                          rds_bits=bits)
    u8 = np.asarray(u8, np.uint8)
    blocks = [u8[i:i + DEFAULT_BUF_LENGTH]
              for i in range(0, len(u8), DEFAULT_BUF_LENGTH)]
    audio, events = _run_stereo(blocks, device, with_rds=True)
    ref_audio, _ = _run_stereo(blocks, ref_device, with_rds=False)
    checks = [
        Check("L 800 Hz tone SNR", synth.tone_snr(audio[0], 800.0, AUDIO_RATE,
                                                  skip=2000), ">", 30.0),
        Check("R 1300 Hz tone SNR", synth.tone_snr(audio[1], 1_300.0,
                                                   AUDIO_RATE, skip=2000),
              ">", 30.0),
        Check(f"PI {pi:04X} decoded", float(f"PI: {pi:04X}" in events), "==",
              1.0, ""),
        Check(f"PS '{ps}' decoded", float(f"PS: '{ps}'" in events), "==", 1.0,
              ""),
        Check("stereo GPU vs CPU", err_db(ref_audio.ravel(), audio.ravel()),
              ">=", FIDELITY_DB),
    ]
    return PhaseResult("stereo", checks, _precision(
        decimator="split_bf16(bf16 x2, f32 acc)", mpx_fir="HIGHEST",
        resampler="HIGH", rds_fir="HIGHEST", rds_resampler="HIGHEST"))


# ---------------------------------------------------------------------------
# Phase 6: rtl_power's PSD
# ---------------------------------------------------------------------------

def _run_psd(blocks, n_fft: int, device) -> np.ndarray:
    from tpu_sdr.ops.spectrum import PsdStreamer

    with jax.default_device(device):
        ps = PsdStreamer(n_fft)
        for b in blocks:
            ps.accumulate(b)
        _on(ps.state.acc, device)
        return np.asarray(ps.state.acc, np.float64), ps.finalize_db()


def spectrum(device, ref_device, sizes: Sizes = Sizes()) -> PhaseResult:
    """The ``rtl_power`` data plane at 2.048 Msps with the FFT size its
    bin width asks for: a complex tone at bin offset n_fft/8 must peak in
    exactly that fftshifted bin, > 30 dB over the median bin, and the
    accumulated power must agree with the CPU run."""
    from tpu_sdr.apps.rtl_power import fft_size_for

    n_fft = fft_size_for(PSD_RATE, sizes.psd_step_hz)
    k = n_fft // 8
    n = sizes.psd_blocks * DEFAULT_BUF_LENGTH // 2
    rng = np.random.default_rng(2)
    ph = 2 * np.pi * (k / n_fft) * np.arange(n)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.clip(np.round(127.5 + 100 * np.cos(ph)
                                + rng.normal(0, 2, n)), 0, 255)
    u8[1::2] = np.clip(np.round(127.5 + 100 * np.sin(ph)
                                + rng.normal(0, 2, n)), 0, 255)
    blocks = [u8[i:i + DEFAULT_BUF_LENGTH]
              for i in range(0, len(u8), DEFAULT_BUF_LENGTH)]
    acc, db = _run_psd(blocks, n_fft, device)
    ref_acc, _ = _run_psd(blocks, n_fft, ref_device)
    peak = int(np.argmax(db))
    checks = [
        Check("peak bin - expected bin", peak - (n_fft // 2 + k), "==", 0,
              "bins"),
        Check("peak over median bin", float(db[peak] - np.median(db)), ">",
              30.0),
        Check("PSD GPU vs CPU", err_db(ref_acc, acc), ">=", FIDELITY_DB),
    ]
    return PhaseResult("spectrum", checks, _precision(fft="complex64"),
                       [f"n_fft {n_fft}, {sizes.psd_blocks} blocks"])


# ---------------------------------------------------------------------------
# Phase 7: one large block through the block transform
# ---------------------------------------------------------------------------

def large_block(device, ref_device=None, sizes: Sizes = Sizes()) -> PhaseResult:
    """``wbfm.demodulate_block`` (fir) on one large block: compile time,
    the compiled step's memory analysis, peak device memory and a few
    timed iterations — first smoke numbers, not a benchmark."""
    from tpu_sdr.models import wbfm

    config = wbfm.WbfmConfig(filter_mode="fir")
    u8, _ = synth.synth_wbfm_u8(sizes.large_complex, capture_rate=FM_RATE)
    with jax.default_device(device):
        params = wbfm.make_params(config)
        state = wbfm.init_state(config)
        buf = jax.device_put(np.asarray(u8, np.uint8), device)
        t0 = time.perf_counter()
        compiled = wbfm.demodulate_block.lower(buf, state, params,
                                               config).compile()
        compile_s = time.perf_counter() - t0
        times, out = [], None
        for _ in range(max(1, sizes.large_iters)):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(buf, state, params))
            times.append(time.perf_counter() - t0)
    _on(out[0], device)
    count = int(out[1])
    audio = np.asarray(out[0])[:count].astype(np.float64)
    want = sizes.large_complex // config.decim * config.resample_up // (
        config.resample_down)
    checks = [
        Check("audio samples - expected", count - want, "==", 0, "samples"),
        Check("non-finite samples", int(np.sum(~np.isfinite(audio))), "==", 0,
              ""),
        Check("tone SNR", synth.tone_snr(audio, 1_000.0, AUDIO_RATE,
                                         skip=1500), ">", 45.0),
    ]
    mem = compiled.memory_analysis()
    info = [f"block {sizes.large_complex} complex ({2 * sizes.large_complex} "
            f"B u8); compile {compile_s:.2f} s"]
    if mem is not None:
        info.append("memory_analysis: " + ", ".join(
            f"{k}={getattr(mem, k)}" for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)))
    stats = device.memory_stats() or {}
    info.append(f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}")
    med = float(np.median(times))
    info.append("iterations (block_until_ready, ms): "
                + ", ".join(f"{1e3 * t:.3f}" for t in times)
                + f"; median {1e3 * med:.3f} ms = "
                  f"{sizes.large_complex / med / 1e6:.1f} complex Msps")
    return PhaseResult("large_block", checks, _precision(**FIR_PRECISION),
                       info)


PHASES = {
    "golden": golden,
    "simple_fm": simple_fm,
    "rtl_tcp": rtl_tcp,
    "wideband": wideband,
    "stereo": stereo,
    "spectrum": spectrum,
    "large_block": large_block,
}


# ---------------------------------------------------------------------------
# Four cards: the sharded chains against their serial references
# ---------------------------------------------------------------------------

MESHES = ((1, 4), (2, 2))


def sharded(devices, sizes: Sizes = Sizes(), meshes=MESHES) -> PhaseResult:
    """The DP x SP sharded WBFM chain (halos by ``ppermute``) on each
    (dp, sp) mesh against a serial ``demodulate_block`` per station row,
    and the time-sharded channelizer (halo + ``all_to_all``) against the
    serial ``pfb_analyze`` + discriminator.  Both sides run on the target
    devices; the serial side on the first."""
    from tpu_sdr.models import wbfm
    from tpu_sdr.ops import channelizer as CH
    from tpu_sdr.ops import fm as F
    from tpu_sdr.parallel import mesh as mesh_mod
    from tpu_sdr.parallel.channelizer_sharded import make_sharded_channelizer
    from tpu_sdr.parallel.wbfm_sharded import (
        make_sharded_wbfm,
        sharded_wbfm_apply,
    )

    # The sharded chain's decimator is f32 (HIGHEST) whatever the config
    # says; the serial reference uses the same, so only the sharding
    # differs between the two sides.
    config = wbfm.WbfmConfig(filter_mode="fir", mxu_precision="f32")
    dev0 = devices[0]
    checks, info = [], []
    for dp, sp in meshes:
        if dp * sp > len(devices):
            raise RuntimeError(f"mesh {dp}x{sp} needs {dp * sp} devices, "
                               f"have {len(devices)}")
        mesh = mesh_mod.make_mesh(dp=dp, sp=sp, devices=devices[:dp * sp])
        chain = make_sharded_wbfm(mesh, config)
        # One synthesized station per row: a constant-envelope signal keeps
        # the discriminator well conditioned (on random bytes, decimated
        # samples near zero turn last-bit differences into large angle
        # errors, whichever side is right).
        rng = np.random.default_rng(10 * dp + sp)
        blocks = np.stack([synth.synth_wbfm_u8(
            sizes.shard_complex * sp, capture_rate=FM_RATE,
            audio_freq=400.0 * (i + 1), noise_std=0.01, seed=i)[0]
            for i in range(dp)])
        audio, counts = sharded_wbfm_apply(chain, blocks)
        jax.block_until_ready((audio, counts))
        t0 = time.perf_counter()
        jax.block_until_ready(sharded_wbfm_apply(chain, blocks))
        step_s = time.perf_counter() - t0
        got = chain.assemble(audio, counts)
        with jax.default_device(dev0):
            params = wbfm.make_params(config)
            rows = []
            for row in blocks:
                a, c, _ = wbfm.demodulate_block(
                    jnp.asarray(row), wbfm.init_state(config), params, config)
                rows.append(np.asarray(a)[: int(c)])
        want = np.stack(rows)
        checks.append(Check(f"wbfm {dp}x{sp} shape match",
                            float(got.shape == want.shape), "==", 1.0, ""))
        checks.append(Check(f"wbfm {dp}x{sp} sharded vs serial",
                            err_db(want.ravel(), got.ravel()), ">=",
                            FIDELITY_DB))
        info.append(f"wbfm {dp}x{sp}: {dp} station(s) x "
                    f"{sizes.shard_complex * sp} complex, max |diff| "
                    f"{float(np.max(np.abs(got - want))) if got.shape == want.shape else math.nan:.3g}, "
                    f"one step {1e3 * step_s:.3f} ms")

        K, T = sizes.shard_channels, 8
        cz = make_sharded_channelizer(mesh, K, taps_per_branch=T)
        n = K * (sizes.shard_complex // K) * sp
        t = np.arange(n)
        x = sum(np.exp(2j * np.pi * ((k + 0.05) / K) * t)
                for k in (2, K // 3, K - 5))
        x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        re_, im_ = x.real.astype(np.float32), x.imag.astype(np.float32)
        got = np.asarray(cz(re_, im_))
        with jax.default_device(dev0):
            G = jnp.asarray(CH.design_pfb(K, T))
            yr, yi, _ = CH.pfb_analyze(jnp.asarray(re_), jnp.asarray(im_), G,
                                       CH.pfb_init(G))
            y, _ = jax.vmap(lambda r, i: F.quadrature_demod(
                r, i, F.quad_init()))(yr.T, yi.T)
            want = np.asarray(y)
        checks.append(Check(f"channelizer {dp}x{sp} sharded vs serial",
                            err_db(want.ravel(), got.ravel()), ">=",
                            FIDELITY_DB))
    return PhaseResult("sharded", checks, _precision(
        decimator="f32(HIGHEST)", resampler="HIGH", pfb="HIGHEST"), info)
