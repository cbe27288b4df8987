"""multi_fm — demodulate MANY WBFM stations from one wideband capture.

The reference's simple_fm tunes a single station per process
(/root/reference/examples/simple_fm.rs); this app is the accelerator
upgrade: a wideband capture is split by the polyphase channelizer and
every selected channel's WBFM tail runs in parallel on the device
(models/wbfm_wideband, BASELINE.json config #3).

Each station's 32 kHz s16 audio is written to ``<out-dir>/station_<ch>.raw``;
with a single ``--channel`` the audio streams to stdout like simple_fm.
``--rds`` runs an RDS receiver on EVERY station's multiplex concurrently —
band-wide station identification from one capture — printing
``[rds ch<N>] PI/PS/RT`` lines to stderr.

Example (synthesize then receive two stations):
  python -m tpu_sdr.apps.multi_fm --file wideband.bin --channels 3,60
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

log = logging.getLogger("multi_fm")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--file", required=True, help="raw u8 I/Q wideband capture")
    p.add_argument("--channels", default="0",
                   help="comma-separated channel indices (k*fs/K offsets)")
    p.add_argument("--num-channels", type=int, default=64)
    p.add_argument("--out-dir", default=None,
                   help="write station_<ch>.raw files here (default: stdout "
                        "when one channel, ./ otherwise)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS on every station; [rds ch<N>] lines "
                        "go to stderr")
    args = p.parse_args(argv)

    from tpu_sdr.models import wbfm_wideband as wb
    from tpu_sdr.native import f32_to_s16
    from tpu_sdr.utils.profiling import BlockStats

    channels = tuple(int(c) for c in args.channels.split(","))
    config = wb.WidebandConfig(num_channels=args.num_channels,
                               channels=channels, emit_mpx=args.rds)
    streamer = wb.WidebandStreamer(config)
    rds_rxs = None
    if args.rds:
        from tpu_sdr.models import rds as rds_mod

        rds_rxs = [rds_mod.RdsStreamDecoder() for _ in channels]
    log.info("Capture rate %.3f Msps, %d channels of %d kHz, stations %s",
             config.capture_rate / 1e6, config.num_channels,
             config.channel_rate // 1000, list(channels))

    single_stdout = args.out_dir is None and len(channels) == 1
    sinks = []
    if not single_stdout:
        out_dir = args.out_dir or "."
        os.makedirs(out_dir, exist_ok=True)
        for ch in channels:
            sinks.append(open(os.path.join(out_dir, f"station_{ch}.raw"), "wb"))

    stats = BlockStats()
    block_bytes = 64 * config.num_channels * config.resample_down * 2
    with open(args.file, "rb") as f:
        while True:
            chunk = f.read(block_bytes)
            if len(chunk) < 2 * config.num_channels:
                break
            data = np.frombuffer(chunk, dtype=np.uint8)
            with stats.block(len(data) // 2):
                audio = streamer.demodulate(data)
            for s, ch in enumerate(channels):
                pcm = f32_to_s16(audio[s])
                if single_stdout:
                    sys.stdout.buffer.write(pcm.tobytes())
                else:
                    sinks[s].write(pcm.tobytes())
            if rds_rxs is not None and streamer.last_mpx is not None:
                for s, ch in enumerate(channels):
                    for event in rds_rxs[s].feed_mpx(streamer.last_mpx[s]):
                        print(f"[rds ch{ch}] {event}", file=sys.stderr,
                              flush=True)
    if single_stdout:
        sys.stdout.buffer.flush()
    for s in sinks:
        s.close()
    log.info("%s", stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
