"""RDS bit recovery — 57 kHz BPSK subcarrier of the FM multiplex.

Decodes the Radio Data System physical layer from the discriminator output
(the same multiplex signal the stereo decoder consumes): the 57 kHz
suppressed-carrier BPSK subcarrier is coherently detected with a carrier
derived from the 19 kHz pilot (RDS locks its carrier and its 1187.5 bps
clock to the pilot: 57k = 3 x 19k, 1187.5 = 19k/16), matched-filtered
against the biphase pulse pair, and differentially decoded to the bit
stream.  The group/block layer lives in this module too: checkword
validation and offset-word sync (:func:`sync_and_parse`, streaming
flywheel in :class:`GroupSynchronizer`) and PS/RadioText assembly
(:class:`RdsText`); :class:`RdsStreamDecoder` ties the whole receiver
together for the CLIs (``rtl_fm --rds``).

Chain (all tpu_sdr.ops.fm building blocks, banded-matmul filters):

    y ──BPF19k→ p ──/A→ cosθ ──(4c³-3c)→ cos3θ ─┐
    y ──BPF57k (same length; arms stay aligned) ─┴─ × ─LPF2.4k→ b(t)
    b ──resample 170k→152k (64 samples per half-symbol exactly)
      ──half-symbol integrate-and-dump → soft bits → sign → diff decode

Timing is recovered by a one-shot eye-opening search over the 128 sample
phases of a bit (see :func:`best_bit_phase`), which a streaming receiver
runs once at lock.

No reference equivalent (the reference is a mono WBFM port).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.ops import fm as F
from tpu_sdr.utils import firdes

RDS_RATE = 1187.5
RESAMPLE_FS = 152_000          # 128 samples per data bit, 64 per half-symbol
SAMPLES_PER_BIT = 128


@dataclass(frozen=True)
class RdsConfig:
    mpx_rate: int = 170_000
    pilot_taps: int = 257
    sub_taps: int = 257        # 57 kHz BPF — same length keeps arms aligned
    post_taps: int = 129       # 2.4 kHz LPF after the product
    resample_taps_per_phase: int = 48

    @property
    def resample_up(self) -> int:
        return RESAMPLE_FS // math.gcd(self.mpx_rate, RESAMPLE_FS)  # 76

    @property
    def resample_down(self) -> int:
        return self.mpx_rate // math.gcd(self.mpx_rate, RESAMPLE_FS)  # 85

    @classmethod
    def for_mpx_rate(cls, mpx_rate: int) -> "RdsConfig":
        """Config for a non-default multiplex rate (e.g. the wideband
        stereo front end's 340 kHz), scaling tap counts with fs so the
        filter transition widths stay put."""
        scale = mpx_rate / 170_000

        def odd(n: float) -> int:
            return int(round(n)) | 1

        return cls(mpx_rate=mpx_rate,
                   pilot_taps=odd(257 * scale) if scale != 1 else 257,
                   sub_taps=odd(257 * scale) if scale != 1 else 257,
                   post_taps=odd(129 * scale) if scale != 1 else 129)


class RdsState(NamedTuple):
    bpf_p: F.FirState
    bpf_s: F.FirState
    lpf: F.FirState
    resamp: F.AlignedResampleState


@dataclass
class RdsParams:
    W_p: jax.Array
    W_s: jax.Array
    W_lp: jax.Array
    resamp_V: jax.Array
    taps: tuple


def make_params(config: RdsConfig) -> RdsParams:
    fs = config.mpx_rate
    bp_p = firdes.bandpass(config.pilot_taps, 19_000.0, 1_500.0, fs)
    bp_s = firdes.bandpass(config.sub_taps, 57_000.0, 2_400.0, fs)
    lp = firdes.lowpass(config.post_taps, 2_400.0, fs)
    h = firdes.resampler_taps(config.resample_up, config.resample_down,
                              taps_per_phase=config.resample_taps_per_phase)
    hp = F.make_polyphase(h, config.resample_up)
    V = F.make_aligned_poly_matrix(hp, config.resample_up,
                                   config.resample_down)
    mk = lambda t: jnp.asarray(F.make_banded_decim_matrix(t, 1))
    return RdsParams(mk(bp_p), mk(bp_s), mk(lp), jnp.asarray(V),
                     (config.pilot_taps, config.sub_taps, config.post_taps))


def init_state(config: RdsConfig) -> RdsState:
    return RdsState(
        F.fir_init(config.pilot_taps), F.fir_init(config.sub_taps),
        F.fir_init(config.post_taps),
        F.aligned_resample_init(config.resample_taps_per_phase),
    )


def _fir1(x, W, num_taps, state):
    out, _im, new = F.fir_decimate_mxu(x, jnp.zeros_like(x), W, num_taps, 1,
                                       state)
    return out, new


@partial(jax.jit, static_argnames=("config",))
def baseband_block(y: jax.Array, state: RdsState, params: RdsParams,
                   config: RdsConfig):
    """Multiplex block (mpx_rate) -> (RDS baseband at 152 kHz, pilot
    amplitude estimate, new state).

    Input length must be a multiple of resample_down (85).  The pilot
    amplitude (RMS*sqrt(2) of the 19 kHz arm) doubles as the lock/squelch
    signal: without a pilot there is no carrier to derive, so the product
    detector output is noise.
    """
    tp, ts, tl = params.taps
    p, bpf_p = _fir1(y, params.W_p, tp, state.bpf_p)
    amp = jnp.sqrt(jnp.maximum(2.0 * jnp.mean(p * p), 1e-12))
    c = p / amp                                 # cos(theta), unit amplitude
    c57 = 4.0 * c * c * c - 3.0 * c             # cos(3*theta)
    x57, bpf_s = _fir1(y, params.W_s, ts, state.bpf_s)
    prod = 2.0 * x57 * c57
    b, lpf = _fir1(prod, params.W_lp, tl, state.lpf)
    # HIGHEST: bitstream recovery — keep full matmul precision here (the
    # HIGH default was A/B-justified only for the wbfm audio epilogue).
    b152, rs = F.aligned_resample(b, params.resamp_V, config.resample_up,
                                  config.resample_down, state.resamp,
                                  precision=jax.lax.Precision.HIGHEST)
    return b152, amp, RdsState(bpf_p, bpf_s, lpf, rs)


def soft_bits(b152: np.ndarray, phase: int) -> np.ndarray:
    """Half-symbol integrate-and-dump at ``phase`` (0..127): soft value per
    data bit = first-half sum minus second-half sum (biphase matched
    filter)."""
    b = np.asarray(b152, np.float64)[phase:]
    nbits = len(b) // SAMPLES_PER_BIT
    h = SAMPLES_PER_BIT // 2
    frames = b[: nbits * SAMPLES_PER_BIT].reshape(nbits, SAMPLES_PER_BIT)
    return frames[:, :h].sum(axis=1) - frames[:, h:].sum(axis=1)


def best_bit_phase(b152: np.ndarray) -> int:
    """Eye-opening search: the bit phase maximizing mean |soft| (a
    streaming receiver runs this once at lock, then tracks)."""
    scores = [np.mean(np.abs(soft_bits(b152, ph)))
              for ph in range(SAMPLES_PER_BIT)]
    return int(np.argmax(scores))


def decode_bits(b152: np.ndarray, phase: int | None = None) -> np.ndarray:
    """Baseband -> differentially-decoded RDS bit stream (uint8)."""
    if phase is None:
        phase = best_bit_phase(b152)
    d = (soft_bits(b152, phase) > 0).astype(np.uint8)
    return d[1:] ^ d[:-1]  # differential decode


class RdsReceiver:
    """Host wrapper: feed multiplex blocks (e.g. the WBFM discriminator
    output), collect the recovered bit stream."""

    def __init__(self, config: RdsConfig | None = None):
        self.config = config or RdsConfig()
        self.params = make_params(self.config)
        self.state = init_state(self.config)
        self._pending = np.zeros(0, np.float32)
        self.pilot_amp = 0.0  # last block's 19 kHz pilot amplitude estimate

    def process(self, mpx: np.ndarray) -> np.ndarray:
        """Multiplex samples in -> 152 kHz RDS baseband out (stream-safe)."""
        data = np.concatenate([self._pending, np.asarray(mpx, np.float32)])
        down = self.config.resample_down
        usable = len(data) - (len(data) % down)
        self._pending = data[usable:]
        if usable == 0:
            return np.zeros(0, np.float32)
        b152, amp, self.state = baseband_block(
            jnp.asarray(data[:usable]), self.state, self.params, self.config)
        self.pilot_amp = float(amp)
        return np.asarray(b152)


jax.tree_util.register_pytree_node(
    RdsParams,
    lambda p: ((p.W_p, p.W_s, p.W_lp, p.resamp_V), p.taps),
    lambda aux, c: RdsParams(*c, aux),
)


# ---------------------------------------------------------------------------
# Block/group layer (host-side parser over the recovered bit stream)
# ---------------------------------------------------------------------------
#
# RDS blocks are 26 bits: 16 information bits followed by a 10-bit checkword
# = CRC(info) XOR the block's offset word (which identifies the block's
# position in the group).  g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1.

_G_POLY = 0b10110111001  # x^10..x^0 coefficients of g(x)
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}


def crc10(info: int) -> int:
    """10-bit CRC of a 16-bit information word: info(x)*x^10 mod g(x)."""
    reg = info << 10
    for bit in range(25, 9, -1):
        if reg & (1 << bit):
            reg ^= _G_POLY << (bit - 10)
    return reg & 0x3FF


def make_block(info: int, offset: str) -> np.ndarray:
    """16-bit word + offset name -> 26 transmitted bits (MSB first)."""
    check = crc10(info) ^ OFFSET_WORDS[offset]
    word = (info << 10) | check
    return np.array([(word >> (25 - i)) & 1 for i in range(26)], np.uint8)


def make_group(words: tuple[int, int, int, int],
               version_b: bool = False) -> np.ndarray:
    """Four 16-bit words -> one 104-bit group (offsets A,B,C|C',D)."""
    offs = ("A", "B", "C'" if version_b else "C", "D")
    return np.concatenate([make_block(w, o) for w, o in zip(words, offs)])


_BURST_TABLE: dict[int, int] | None = None


def _burst_table() -> dict[int, int]:
    """syndrome -> 26-bit error vector for every burst of length <= 5.

    The RDS (26,16) shortened cyclic code corrects any single burst of up
    to 5 bits; for this g(x) the 367 burst syndromes are collision-free
    (asserted by tests), so correction is an exact table lookup."""
    global _BURST_TABLE
    if _BURST_TABLE is None:
        table: dict[int, int] = {}
        for start in range(26):
            for pat in range(1, 32, 2):  # LSB set = canonical burst form
                e = pat << start
                if e >= (1 << 26):
                    continue
                table[crc10(e >> 10) ^ (e & 0x3FF)] = e
        _BURST_TABLE = table
    return _BURST_TABLE


def correct_block(bits26: np.ndarray, offset: str):
    """Validate 26 bits against a KNOWN offset word, correcting one burst
    of up to 5 bits.  Returns (info word, n_corrected_bits) or None.

    Correction only makes sense once block sync is established (the offset
    is known); trying all five offsets during acquisition would multiply
    the false-correction rate, so :func:`sync_and_parse` and the
    synchronizer's search phase stay exact-match."""
    word = 0
    for b in bits26:
        word = (word << 1) | int(b)
    info, check = word >> 10, word & 0x3FF
    syndrome = check ^ crc10(info) ^ OFFSET_WORDS[offset]
    if syndrome == 0:
        return info, 0
    e = _burst_table().get(syndrome)
    if e is None:
        return None
    return (word ^ e) >> 10, int(bin(e).count("1"))


def _block_offset(bits26: np.ndarray) -> str | None:
    info = 0
    for b in bits26[:16]:
        info = (info << 1) | int(b)
    check = 0
    for b in bits26[16:]:
        check = (check << 1) | int(b)
    want = check ^ crc10(info)
    for name, off in OFFSET_WORDS.items():
        if want == off:
            return name
    return None


def sync_and_parse(bits: np.ndarray, max_groups: int = 64):
    """Find block sync in a recovered bit stream and parse groups.

    Returns a list of 4-tuples of 16-bit words (one per group with all four
    blocks passing their checkwords).  A real receiver adds error
    correction and flywheel sync; this is the validating parser.
    """
    bits = np.asarray(bits, np.uint8)
    seq = ("A", "B", None, "D")  # None: C or C'
    for start in range(min(len(bits) - 104, 26 * 4)):
        ok = True
        for blk, want in enumerate(seq):
            got = _block_offset(bits[start + 26 * blk: start + 26 * (blk + 1)])
            if want is None:
                ok &= got in ("C", "C'")
            else:
                ok &= got == want
        if not ok:
            continue
        groups = []
        pos = start
        while pos + 104 <= len(bits) and len(groups) < max_groups:
            words = []
            for blk in range(4):
                w26 = bits[pos + 26 * blk: pos + 26 * (blk + 1)]
                if _block_offset(w26) is None:
                    words = None
                    break
                info = 0
                for b in w26[:16]:
                    info = (info << 1) | int(b)
                words.append(info)
            if words is not None:
                groups.append(tuple(words))
            pos += 104
        return groups
    return []


# ---------------------------------------------------------------------------
# Streaming receiver: lock -> bits -> flywheel group sync -> PS/RT text
# ---------------------------------------------------------------------------


class GroupSynchronizer:
    """Streaming block/group synchronizer with flywheel behavior.

    Feed differentially-decoded bits in any chunking; groups whose four
    blocks all pass their checkwords come out.  While synced, a bad block
    drops only its group; ``max_bad_groups`` consecutive failures force a
    full re-search (the classic flywheel, which a one-shot
    :func:`sync_and_parse` cannot provide on an unbounded stream).
    """

    def __init__(self, max_bad_groups: int = 4, correct: bool = True):
        self._bits = np.zeros(0, np.uint8)
        self._max_bad = max_bad_groups
        self._correct = correct
        self.synced = False
        self._bad_run = 0
        self.groups_ok = 0
        self.groups_bad = 0
        self.blocks_corrected = 0  # blocks repaired by burst correction
        self.bits_corrected = 0

    @staticmethod
    def _group_at(bits: np.ndarray, pos: int):
        """Exact-validate 104 bits at pos; return the 4 info words or None.
        (Acquisition path: no correction, see :func:`correct_block`.)"""
        words = []
        for blk, want in enumerate(("A", "B", None, "D")):
            w26 = bits[pos + 26 * blk: pos + 26 * (blk + 1)]
            got = _block_offset(w26)
            if (got not in ("C", "C'")) if want is None else (got != want):
                return None
            info = 0
            for b in w26[:16]:
                info = (info << 1) | int(b)
            words.append(info)
        return tuple(words)

    def _group_at_corrected(self, bits: np.ndarray, pos: int):
        """Validate with known offsets + burst correction (synced path)."""
        words = []
        n_corr_blocks = n_corr_bits = 0
        for blk, want in enumerate(("A", "B", None, "D")):
            w26 = bits[pos + 26 * blk: pos + 26 * (blk + 1)]
            if want is None:
                r = correct_block(w26, "C")
                if r is None or r[1]:  # ambiguous C/C': prefer clean C'
                    r2 = correct_block(w26, "C'")
                    if r2 is not None and (r is None or r2[1] < r[1]):
                        r = r2
            else:
                r = correct_block(w26, want)
            if r is None:
                return None
            info, nbits = r
            if nbits:
                n_corr_blocks += 1
                n_corr_bits += nbits
            words.append(info)
        self.blocks_corrected += n_corr_blocks
        self.bits_corrected += n_corr_bits
        return tuple(words)

    def feed(self, bits: np.ndarray) -> list[tuple[int, int, int, int]]:
        self._bits = np.concatenate(
            [self._bits, np.asarray(bits, np.uint8)])
        out: list[tuple[int, int, int, int]] = []
        while True:
            if not self.synced:
                # search every alignment for one full valid group
                found = None
                for start in range(len(self._bits) - 103):
                    g = self._group_at(self._bits, start)
                    if g is not None:
                        found = start
                        break
                if found is None:
                    # keep one group's worth of tail for the next search
                    if len(self._bits) > 104:
                        self._bits = self._bits[len(self._bits) - 104:]
                    return out
                self._bits = self._bits[found:]
                self.synced = True
                self._bad_run = 0
            if len(self._bits) < 104:
                return out
            g = (self._group_at_corrected(self._bits, 0) if self._correct
                 else self._group_at(self._bits, 0))
            self._bits = self._bits[104:]
            if g is not None:
                out.append(g)
                self.groups_ok += 1
                self._bad_run = 0
            else:
                self.groups_bad += 1
                self._bad_run += 1
                if self._bad_run >= self._max_bad:
                    self.synced = False  # bit slip — re-acquire


PTY_NONE = 0

# RDS (IEC 62106 / EBU) programme-type names, codes 0-31.
PTY_NAMES = (
    "None", "News", "Current Affairs", "Information", "Sport", "Education",
    "Drama", "Culture", "Science", "Varied", "Pop Music", "Rock Music",
    "Easy Listening", "Light Classical", "Serious Classical", "Other Music",
    "Weather", "Finance", "Children's Programmes", "Social Affairs",
    "Religion", "Phone-In", "Travel", "Leisure", "Jazz Music",
    "Country Music", "National Music", "Oldies Music", "Folk Music",
    "Documentary", "Alarm Test", "Alarm",
)


def af_code_mhz(code: int) -> float | None:
    """Alternative-frequency code (1-204) -> carrier MHz, else None."""
    if 1 <= code <= 204:
        return round(87.5 + 0.1 * code, 1)
    return None


def mjd_to_date(mjd: int) -> tuple[int, int, int]:
    """Modified Julian Day -> (year, month, day) (IEC 62106 annex G)."""
    yp = int((mjd - 15078.2) / 365.25)
    mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
    day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
    k = 1 if mp in (14, 15) else 0
    return 1900 + yp + k, mp - 1 - 12 * k, day


class RdsText:
    """Assemble program service name (PS) and RadioText (RT) from groups.

    Group type 0 (A/B) carries PS two chars per group in word D, segment in
    the low 2 bits of word B; type 2A carries RT four chars per group in
    words C+D (2B: two chars in D), segment in the low 4 bits of B, with a
    text A/B toggle that clears the buffer on change.  Type 0A's word C
    carries the alternative-frequency list (method-A: a 224+N count code
    followed by N frequency codes); type 4A is clock-time/date (MJD +
    UTC hour/minute + signed half-hour local offset).
    """

    def __init__(self):
        self.pi: int | None = None
        self.pty: int = PTY_NONE
        self._ps = [None] * 8
        self._rt = [None] * 64
        self._rt_flag: int | None = None
        self.ps: str | None = None   # last completed PS
        self.rt: str | None = None   # last completed (or grown) RT
        self._af_expect: int = 0     # announced AF count (method A)
        self._af_partial: list[float] = []
        self.af: list[float] | None = None  # last completed AF list (MHz)
        self.ct: str | None = None   # last decoded clock-time string
        self._ptyn = [None] * 8      # 10A programme-type-name assembly
        self._ptyn_flag: int | None = None
        self.ptyn: str | None = None

    @staticmethod
    def _chars(word: int) -> list[str]:
        return [chr((word >> 8) & 0xFF), chr(word & 0xFF)]

    def update(self, group: tuple[int, int, int, int]) -> list[str]:
        """Apply one validated group; return human-readable news."""
        a, b, c, d = group
        events: list[str] = []
        if self.pi != a:
            self.pi = a
            events.append(f"PI: {a:04X}")
        pty = (b >> 5) & 0x1F
        if pty != self.pty:
            self.pty = pty
            events.append(f"PTY: {pty} ({PTY_NAMES[pty]})")
        gtype, version_b = b >> 12, (b >> 11) & 1
        if gtype == 0:
            if not version_b:  # 0A word C: two AF codes (method A)
                events.extend(self._feed_af((c >> 8) & 0xFF))
                events.extend(self._feed_af(c & 0xFF))
            seg = b & 0x3
            self._ps[2 * seg: 2 * seg + 2] = self._chars(d)
            if None not in self._ps:
                ps = "".join(self._ps)
                if ps != self.ps:
                    self.ps = ps
                    events.append(f"PS: {ps!r}")
        elif gtype == 2:
            flag = (b >> 4) & 1
            if self._rt_flag is not None and flag != self._rt_flag:
                self._rt = [None] * 64  # text changed — restart assembly
            self._rt_flag = flag
            seg = b & 0xF
            if version_b:
                self._rt[2 * seg: 2 * seg + 2] = self._chars(d)
            else:
                self._rt[4 * seg: 4 * seg + 4] = (self._chars(c)
                                                  + self._chars(d))
            filled = [ch for ch in self._rt if ch is not None]
            text = "".join(ch if ch is not None else " " for ch in self._rt)
            # RT terminates at 0x0D; report once a terminator (or the full
            # 64 chars) is assembled and the text grew/changed
            if "\r" in filled or len(filled) == 64:
                rt = text.split("\r")[0].rstrip()
                if rt and rt != self.rt:
                    self.rt = rt
                    events.append(f"RT: {rt!r}")
        elif gtype == 4 and not version_b:
            events.extend(self._decode_ct(b, c, d))
        elif gtype == 10 and not version_b:
            # 10A: 8-char programme-type name, 4 chars per group, segment
            # in B bit 0, A/B toggle in B bit 4 clears on change
            flag = (b >> 4) & 1
            if self._ptyn_flag is not None and flag != self._ptyn_flag:
                self._ptyn = [None] * 8
            self._ptyn_flag = flag
            seg = b & 0x1
            self._ptyn[4 * seg: 4 * seg + 4] = (self._chars(c)
                                                + self._chars(d))
            if None not in self._ptyn:
                ptyn = "".join(self._ptyn).rstrip()
                if ptyn and ptyn != self.ptyn:
                    self.ptyn = ptyn
                    events.append(f"PTYN: {ptyn!r}")
        return events

    def _feed_af(self, code: int) -> list[str]:
        """One AF code (method A): 224+N announces an N-entry list, 1-204
        are carrier frequencies, everything else (filler 205, LF/MF escape
        250, unused 0) is skipped."""
        if 225 <= code <= 249:
            self._af_expect = code - 224
            self._af_partial = []
            return []
        mhz = af_code_mhz(code)
        if mhz is None or self._af_expect == 0:
            return []
        if mhz not in self._af_partial:
            self._af_partial.append(mhz)
        if len(self._af_partial) >= self._af_expect:
            done = sorted(self._af_partial)
            self._af_expect = 0
            self._af_partial = []
            if done != self.af:
                self.af = done
                return ["AF: " + ", ".join(f"{f:.1f}" for f in done) + " MHz"]
        return []

    def _decode_ct(self, b: int, c: int, d: int) -> list[str]:
        """Type 4A clock-time: 17-bit MJD (B[1:0] high, C[15:1] low), 5-bit
        UTC hour (C[0] high, D[15:12] low), 6-bit minute D[11:6], signed
        half-hour local offset D[5:0]."""
        mjd = ((b & 0x3) << 15) | (c >> 1)
        if mjd == 0:  # transmitter has no date — per spec, ignore
            return []
        hour = ((c & 1) << 4) | (d >> 12)
        minute = (d >> 6) & 0x3F
        off_half = d & 0x1F
        offset = -off_half if (d >> 5) & 1 else off_half
        year, month, day = mjd_to_date(mjd)
        sign = "+" if offset >= 0 else "-"
        ct = (f"{year:04d}-{month:02d}-{day:02d} {hour:02d}:{minute:02d} "
              f"UTC{sign}{abs(offset) // 2}"
              + (":30" if abs(offset) % 2 else ":00"))
        if ct == self.ct:
            return []
        self.ct = ct
        return [f"CT: {ct}"]


class RdsStreamDecoder:
    """The full streaming RDS receiver: multiplex blocks in, text out.

    Locking: waits for the 19 kHz pilot (``pilot_amp`` over threshold) and
    ``lock_bits`` worth of baseband, runs the :func:`best_bit_phase` eye
    search ONCE, then free-runs: half-symbol integrate-and-dump on the
    locked phase with partial-frame and differential carries across calls,
    flywheel group sync, PS/RT assembly.
    """

    def __init__(self, config: RdsConfig | None = None,
                 lock_bits: int = 104, pilot_threshold: float = 0.02):
        self.rx = RdsReceiver(config)
        self.lock_bits = lock_bits
        self.pilot_threshold = pilot_threshold
        self.phase: int | None = None
        self._bb = np.zeros(0, np.float32)   # baseband awaiting lock/frames
        self._prev_raw: int | None = None    # differential-decode carry
        self.sync = GroupSynchronizer()
        self.text = RdsText()

    @property
    def locked(self) -> bool:
        return self.phase is not None

    def feed_mpx(self, mpx: np.ndarray) -> list[str]:
        """FM multiplex samples (discriminator output) in -> text events."""
        self._bb = np.concatenate([self._bb, self.rx.process(mpx)])
        if not self.locked:
            if self.rx.pilot_amp < self.pilot_threshold:
                # no pilot, no carrier: drop stale baseband, stay unlocked
                self._bb = self._bb[-SAMPLES_PER_BIT:]
                return []
            if len(self._bb) < self.lock_bits * SAMPLES_PER_BIT:
                return []
            self.phase = best_bit_phase(self._bb)
            self._bb = self._bb[self.phase:]
        nbits = len(self._bb) // SAMPLES_PER_BIT
        if nbits == 0:
            return []
        frames = self._bb[: nbits * SAMPLES_PER_BIT].reshape(
            nbits, SAMPLES_PER_BIT)
        self._bb = self._bb[nbits * SAMPLES_PER_BIT:]
        h = SAMPLES_PER_BIT // 2
        raw = (frames[:, :h].sum(axis=1) - frames[:, h:].sum(axis=1)
               > 0).astype(np.uint8)
        if self._prev_raw is None:
            bits = raw[1:] ^ raw[:-1]
        else:
            bits = np.concatenate([[raw[0] ^ self._prev_raw],
                                   raw[1:] ^ raw[:-1]]).astype(np.uint8)
        self._prev_raw = int(raw[-1])
        events: list[str] = []
        for group in self.sync.feed(bits):
            events.extend(self.text.update(group))
        return events


def make_group_0a(pi: int, pty: int, segment: int, ps_pair: str,
                  af: int = 0xE0E0) -> np.ndarray:
    """Encode one type-0A group carrying two PS characters (test/signal
    generator helper — the inverse of what :class:`RdsText` consumes)."""
    b = (0 << 12) | ((pty & 0x1F) << 5) | (segment & 0x3)
    d = (ord(ps_pair[0]) << 8) | ord(ps_pair[1])
    return make_group((pi, b, af, d))


def make_group_4a(pi: int, mjd: int, hour: int, minute: int,
                  offset_half_hours: int = 0, pty: int = 0) -> np.ndarray:
    """Encode one type-4A clock-time group (inverse of the CT decoder)."""
    b = (4 << 12) | ((pty & 0x1F) << 5) | ((mjd >> 15) & 0x3)
    c = ((mjd & 0x7FFF) << 1) | ((hour >> 4) & 1)
    sign = 1 if offset_half_hours < 0 else 0
    d = ((hour & 0xF) << 12) | ((minute & 0x3F) << 6) | (sign << 5) | (
        abs(offset_half_hours) & 0x1F)
    return make_group((pi, b, c, d))


def make_group_2a(pi: int, pty: int, segment: int, rt_quad: str,
                  text_flag: int = 0) -> np.ndarray:
    """Encode one type-2A group carrying four RadioText characters."""
    b = (2 << 12) | ((pty & 0x1F) << 5) | ((text_flag & 1) << 4) | (
        segment & 0xF)
    c = (ord(rt_quad[0]) << 8) | ord(rt_quad[1])
    d = (ord(rt_quad[2]) << 8) | ord(rt_quad[3])
    return make_group((pi, b, c, d))


def make_group_10a(pi: int, segment: int, ptyn_quad: str, pty: int = 0,
                   flag: int = 0) -> np.ndarray:
    """Encode one type-10A group carrying four PTYN characters."""
    b = (10 << 12) | ((pty & 0x1F) << 5) | ((flag & 1) << 4) | (segment & 1)
    c = (ord(ptyn_quad[0]) << 8) | ord(ptyn_quad[1])
    d = (ord(ptyn_quad[2]) << 8) | ord(ptyn_quad[3])
    return make_group((pi, b, c, d))
