"""simple_fm — WBFM receiver emitting raw s16 mono audio on stdout.

Mirrors /root/reference/examples/simple_fm.rs: hard-coded-by-default station
config, a receive thread feeding a demod thread through a queue (the
reference's mpsc pipeline, simple_fm.rs:55-63), or file mode which streams a
raw capture through the same demodulator (simple_fm.rs:65-84).  The demod
thread dispatches blocks to the JAX data plane (the GPU when present).

Play with:  python -m tpu_sdr.apps.simple_fm | play -r 32k -t raw -e s -b 16 -c 1 -V1 -

Modes (--mode):
  exact   bit-exact integer chain (the conformance path)
  boxcar  float reference-parity chain (fast, >=60 dB vs exact)
  fir     FIR quality chain (best audio)
  stereo  pilot-tone stereo decoder -> interleaved L/R s16 (play with -c 2)

``--rds`` (stereo mode) additionally decodes the Radio Data System from
the same multiplex and prints PI/PS/RadioText lines to stderr.
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading

import numpy as np

from tpu_sdr import DEFAULT_BUF_LENGTH
from tpu_sdr.api import DeviceId, RtlSdr, TunerGain

log = logging.getLogger("simple_fm")

FREQUENCY = 94_900_000  # Hz (ref simple_fm.rs:25)
SAMPLE_RATE = 170_000  # demod rate (ref simple_fm.rs:26)
RATE_RESAMPLE = 32_000  # audio out (ref simple_fm.rs:27)


def make_demodulator(mode: str, deemph_us: float = 0.0, rds: bool = False):
    """Return (demod_fn(u8 block)->np audio s16, description)."""
    from tpu_sdr.models import wbfm, wbfm_exact

    if mode == "exact":
        streamer = wbfm_exact.WbfmExactStreamer()
        return streamer.demodulate, "exact integer chain"
    if mode == "stereo":
        from tpu_sdr.models.wbfm_stereo import StereoConfig, WbfmStereoStreamer
        from tpu_sdr.native import f32_to_s16

        st_config = StereoConfig(emit_mpx=rds,
                                 deemphasis_tau=deemph_us * 1e-6)
        st = WbfmStereoStreamer(st_config)
        rds_rx = None
        if rds:
            from tpu_sdr.models import rds as rds_mod

            # the stereo front is wideband (340 kHz multiplex by default);
            # the RDS decoder's filters must be designed for that rate
            rds_rx = rds_mod.RdsStreamDecoder(
                rds_mod.RdsConfig.for_mpx_rate(st_config.base.rate_out))

        def demod_stereo(buf: np.ndarray) -> np.ndarray:
            audio = st.demodulate(buf)  # (2, m)
            if rds_rx is not None and st.last_mpx is not None:
                for event in rds_rx.feed_mpx(st.last_mpx):
                    print(f"[rds] {event}", file=sys.stderr, flush=True)
            return f32_to_s16(audio.T.reshape(-1))  # interleaved L/R s16

        desc = "stereo multiplex decoder (pilot-tone)"
        return demod_stereo, desc + (" + RDS" if rds else "")
    filter_mode = "boxcar" if mode == "boxcar" else "fir"
    streamer = wbfm.WbfmStreamer(wbfm.WbfmConfig(
        filter_mode=filter_mode, deemphasis_tau=deemph_us * 1e-6))
    desc = f"float chain ({filter_mode})"
    if deemph_us:
        desc += f", {deemph_us:.0f}us de-emphasis"

    from tpu_sdr.native import f32_to_s16

    def demod(buf: np.ndarray) -> np.ndarray:
        # float [-1,1] -> s16, matching the reference's output format
        # (native clamp/convert when the C++ runtime is built)
        return f32_to_s16(streamer.demodulate(buf))

    return demod, desc


def output(buf: np.ndarray) -> None:
    """Raw s16-LE to stdout (ref simple_fm.rs:430-438)."""
    sys.stdout.buffer.write(np.asarray(buf, dtype="<i2").tobytes())
    sys.stdout.buffer.flush()


def process_loop(demod, feeder, shutdown: threading.Event,
                 max_blocks: int = 0):
    """Demod loop with running-average timing (ref process,
    simple_fm.rs:135-170).  The receive side is the feeder's reader (the
    native C++ pump/ring when built — the reference's receive thread,
    simple_fm.rs:89-132)."""
    from tpu_sdr.utils.profiling import BlockStats

    stats = BlockStats()
    for data in feeder.blocks():
        if shutdown.is_set():
            break
        with stats.block(len(data) // 2):
            audio = demod(data)
        output(audio)
        if max_blocks and stats.blocks >= max_blocks:
            break
    stats.drop(feeder.dropped)
    if stats.blocks:
        log.info("Average processing time: %.2fms (%d loops); %s",
                 stats.avg_block_ms, stats.blocks, stats.summary())


def run_file(path: str, demod) -> None:
    """File mode (ref simple_fm.rs:65-84)."""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(DEFAULT_BUF_LENGTH)
            if len(chunk) < 16:
                break
            usable = len(chunk) - (len(chunk) % 16)
            audio = demod(np.frombuffer(chunk[:usable], dtype=np.uint8))
            output(audio)


def main(argv=None) -> int:
    # Log to stderr; stdout carries audio (ref simple_fm.rs:38)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--freq", type=int, default=FREQUENCY)
    p.add_argument("--file", help="read raw u8 I/Q from file instead of a device")
    p.add_argument("--tcp", metavar="HOST:PORT",
                   help="stream from a remote rtl_tcp server instead of a "
                        "local device (tunes it to --freq)")
    p.add_argument("--device", type=int, default=0)
    p.add_argument("--mode",
                   choices=["exact", "boxcar", "fir", "stereo"],
                   default="fir")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a jax.profiler device trace to DIR")
    p.add_argument("--deemph", type=float, default=0.0, metavar="US",
                   help="de-emphasis time constant in microseconds "
                        "(75 US / 50 EU; fir/boxcar modes)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS alongside the audio (stereo mode); "
                        "PI/PS/RadioText lines go to stderr")
    p.add_argument("--blocks", type=int, default=0,
                   help="stop after N blocks (device/tcp modes; 0 = run "
                        "until interrupted)")
    args = p.parse_args(argv)
    if args.rds and args.mode != "stereo":
        p.error("--rds requires --mode stereo here (for mono use "
                "rtl_fm --rds)")

    from tpu_sdr.models.wbfm_exact import optimal_settings
    from tpu_sdr.utils.profiling import trace

    radio, _demod_cfg = optimal_settings(args.freq, SAMPLE_RATE)
    demod, desc = make_demodulator(args.mode, args.deemph, rds=args.rds)
    log.info("Demodulating with %s", desc)

    if args.file:
        with trace(args.trace):
            run_file(args.file, demod)
        return 0

    from tpu_sdr.stream.feeder import BlockFeeder

    if args.tcp:
        from tpu_sdr.stream.feeder import RtlTcpClientSource

        host, _, port = args.tcp.rpartition(":")
        src = RtlTcpClientSource(host or "127.0.0.1", int(port))
        src.set_sample_rate(radio.capture_rate)
        src.set_frequency(radio.capture_freq)
        src.set_gain_mode(False)
        log.info("Streaming from rtl_tcp://%s (tuner type %d), tuned to "
                 "%d Hz at %d S/s", args.tcp, src.tuner_type,
                 radio.capture_freq, radio.capture_rate)
        shutdown = threading.Event()
        feeder = BlockFeeder(src, block_bytes=DEFAULT_BUF_LENGTH,
                             queue_blocks=16).start()
        try:
            with trace(args.trace):
                process_loop(demod, feeder, shutdown, args.blocks)
        except KeyboardInterrupt:
            shutdown.set()
        finally:
            feeder.stop()
        return 0

    sdr = RtlSdr.open(DeviceId.index(args.device))
    # Configure like the reference (config_sdr, simple_fm.rs:217-229)
    sdr.set_tuner_gain(TunerGain.AUTO)
    sdr.set_bias_tee(False)
    sdr.reset_buffer()
    sdr.set_center_freq(radio.capture_freq)
    sdr.set_sample_rate(radio.capture_rate)
    log.info("Tuned to %d Hz.", sdr.get_center_freq())
    log.info("Buffer size: %.2fms",
             1000.0 * 0.5 * DEFAULT_BUF_LENGTH / radio.capture_rate)
    log.info("Sampling at %d S/s", sdr.get_sample_rate())

    from tpu_sdr.stream.feeder import BlockFeeder, DeviceSource

    shutdown = threading.Event()
    feeder = BlockFeeder(DeviceSource(sdr), block_bytes=DEFAULT_BUF_LENGTH,
                         queue_blocks=16).start()
    try:
        with trace(args.trace):
            process_loop(demod, feeder, shutdown, args.blocks)
    except KeyboardInterrupt:
        shutdown.set()
    finally:
        feeder.stop()  # also closes the device
        log.info("Close")
    return 0


if __name__ == "__main__":
    sys.exit(main())
