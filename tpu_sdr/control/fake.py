"""Register-level RTL2832U + R82xx simulator.

The reference mocks the USB HAL per-test with mockall expectations
(/root/reference/src/device/mock_device_handle.rs,
src/device/device_test.rs).  This framework goes further (SURVEY.md §4/§7):
a persistent *behavioral* simulator that implements the same control-transfer
wire protocol a real dongle speaks, so the entire control plane — init
sequence, tuner probe, PLL programming, EEPROM hacks, test mode — runs
unmodified against it and can be asserted on.

Simulated behavior:

* system/USB/demod register files addressed exactly like the hardware:
  ``index = block<<8 (|0x10 on write)`` for blocks, ``value = (addr<<8)|0x20,
  index = page (|0x10 on write)`` for demod pages (ref device/mod.rs:63-139),
* I2C tunnel through BLOCK_IIC: tuner register file at the R82xx address
  with write-[reg,data...]/read-from-pointer semantics, including the raw
  byte values the driver bit-reverses (ref r82xx.rs:1139-1148) — probe
  value, PLL lock bit, VCO fine-tune and filter-calibration codes are all
  served so the driver takes its real code paths,
* 256-byte EEPROM at 0xA0 with an address-pointer write followed by
  sequential reads (ref device/mod.rs:145-152),
* bulk endpoint 0x81 backed by a pluggable sample source; the on-chip
  counter test pattern is honored when demod page0 reg 0x19 == 0x03
  (ref rtlsdr.rs:280-290).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from tpu_sdr.control import constants as C
from tpu_sdr.errors import UsbError


def bit_reverse_u8(b: int) -> int:
    """Reverse the bits of a byte (the R82xx serves MSB-first reads;
    ref r82xx.rs:1160-1165)."""
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4)
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2)
    b = ((b & 0xAA) >> 1) | ((b & 0x55) << 1)
    return b


# Raw (wire) R82xx read-register bytes the simulator serves.  The driver
# bit-reverses what it reads (r82xx.rs:1144-1147), so these are chosen to
# present: probe value 0x69 at reg 0 (tuners/mod.rs & r82xx.rs:330-344);
# PLL lock bit (reversed & 0x40) at reg 2 (r82xx.rs:783-801); VCO fine tune
# == the chip's vco_power_ref (2 for R820T, 1 for R828D — serving the
# matching value keeps the driver's div_num adjustment at 0, which the
# PLL inversion in decode_tuned_freq relies on) and fil_cal_code == 0 at
# reg 4 (r82xx.rs:726-731, 1015-1024).
def _r82xx_read_regs(vco_power_ref: int) -> bytes:
    return bytes([
        0x69,                          # reg 0: chip id / probe check value
        0x00,                          # reg 1
        bit_reverse_u8(0x40),          # reg 2: PLL locked
        bit_reverse_u8(0x42),          # reg 3: mixer/lna gain readout
        bit_reverse_u8(vco_power_ref << 4),  # reg 4: vco_fine_tune, cal=0
    ])


_R82XX_READ_REGS = _r82xx_read_regs(2)  # R820T default (back-compat)


class SampleSource:
    """Pluggable bulk-endpoint signal source."""

    def read(self, length: int) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError


class CounterSource(SampleSource):
    """The RTL2832U's built-in 8-bit counter test pattern
    (enabled via demod reg 0x19=0x03; ref rtlsdr.rs:280-290)."""

    def __init__(self):
        self._next = 0

    def read(self, length: int) -> bytes:
        out = bytes((self._next + i) & 0xFF for i in range(length))
        self._next = (self._next + length) & 0xFF
        return out


class SynthFmSource(SampleSource):
    """Synthesized WBFM station (see tpu_sdr.utils.synth) looped forever —
    the stand-in for an antenna."""

    def __init__(self, capture_rate: float = 2_048_000.0, audio_freq: float = 1_000.0,
                 seconds: float = 1.0, noise_std: float = 0.005):
        from tpu_sdr.utils import synth

        n = int(capture_rate * seconds)
        u8, _ = synth.synth_wbfm_u8(
            n, capture_rate=capture_rate, audio_freq=audio_freq, noise_std=noise_std
        )
        self._data = bytes(u8)
        self._pos = 0

    def read(self, length: int) -> bytes:
        out = bytearray()
        while len(out) < length:
            take = min(length - len(out), len(self._data) - self._pos)
            out += self._data[self._pos : self._pos + take]
            self._pos = (self._pos + take) % len(self._data)
        return bytes(out)


@dataclass
class FakeDeviceSpec:
    """Identity + personality of one simulated dongle."""

    vendor_id: int = 0x0BDA
    product_id: int = 0x2838
    manufacturer: str = "Realtek"
    product: str = "RTL2838UHIDIR"
    serial: str = "00000001"
    is_blog_v4: bool = False
    eeprom: bytes = b""
    source_factory: Callable[[], SampleSource] | None = None

    def make_eeprom(self) -> bytearray:
        if self.eeprom:
            e = bytearray(self.eeprom)
            e.extend(b"\x00" * (C.EEPROM_SIZE - len(e)))
            return e[: C.EEPROM_SIZE]
        e = bytearray(C.EEPROM_SIZE)
        e[0] = 0x28  # RTL eeprom magic
        e[1] = 0x32
        # Byte 7 default: IR endpoint enabled (bit1=1 -> force_bt off) and
        # remote disabled (bit0=0 -> force_ds off); ref rtlsdr.rs:118-124.
        e[7] = 0x02
        return e


class FakeUsbBackend:
    """A UsbBackend implementation simulating one dongle at the wire level."""

    def __init__(self, spec: FakeDeviceSpec | None = None):
        self.spec = spec or FakeDeviceSpec()
        if self.spec.is_blog_v4:
            self.spec = dataclass_replace(
                self.spec, manufacturer="RTLSDRBlog", product="Blog V4"
            )
        self.sys_regs: dict[tuple[int, int], int] = {}
        self.demod_regs: dict[tuple[int, int], int] = {}
        self.tuner_regs = bytearray(32)
        self._tuner_read_ptr = 0
        # A Blog V4 board carries an R828D at I2C 0x74 (the driver's
        # probe at the R820T's 0x34 must NAK, like real hardware); plain
        # boards simulate the R820T at 0x34.
        if self.spec.is_blog_v4:
            self.tuner_i2c_addr = 0x74
            self._read_regs = _r82xx_read_regs(1)  # R828D vco_power_ref
        else:
            self.tuner_i2c_addr = 0x34
            self._read_regs = _r82xx_read_regs(2)
        self.eeprom = self.spec.make_eeprom()
        self._eeprom_ptr = 0
        self.claimed: list[int] = []
        self.reset_count = 0
        self.closed = False
        factory = self.spec.source_factory or CounterSource
        self._source = factory()
        if hasattr(self._source, "attach"):
            self._source.attach(self)  # frequency-aware sources
        self._counter = CounterSource()
        self.log: list[tuple] = []  # protocol trace for assertions

    # -- UsbBackend interface ---------------------------------------------

    def claim_interface(self, iface: int) -> None:
        self.claimed.append(iface)

    def reset(self) -> None:
        self.reset_count += 1

    def read_control(self, request_type, request, value, index, length, timeout_ms):
        if request_type != C.CTRL_IN:
            raise UsbError(f"unexpected read request_type {request_type:#x}")
        self.log.append(("read", value, index, length))
        if index < 0x100:
            # Demod page read: value = (addr<<8)|0x20, index = page
            # (ref device/mod.rs:86-111).
            page, addr = index, value >> 8
            return bytes([self.demod_regs.get((page, addr), 0) & 0xFF, 0])[:length]
        block = index >> 8
        if block == C.BLOCK_IIC:
            return self._i2c_read(value, length)
        # Plain block register read — served little-endian
        # (ref device/mod.rs:63-71 "read as little endian").
        val = self.sys_regs.get((block, value), 0)
        return bytes([val & 0xFF, (val >> 8) & 0xFF])[:length]

    def write_control(self, request_type, request, value, index, data, timeout_ms):
        if request_type != C.CTRL_OUT:
            raise UsbError(f"unexpected write request_type {request_type:#x}")
        self.log.append(("write", value, index, bytes(data)))
        if not index & 0x10:
            raise UsbError(f"write without 0x10 marker: index={index:#x}")
        if index < 0x100:
            # Demod page write: index = 0x10|page, value = (addr<<8)|0x20
            # (ref device/mod.rs:114-139).
            page, addr = index & 0x0F, value >> 8
            v = data[0] if len(data) == 1 else (data[0] << 8) | data[1]
            self.demod_regs[(page, addr)] = v
            return len(data)
        block = index >> 8
        if block == C.BLOCK_IIC:
            self._i2c_write(value, bytes(data))
            return len(data)
        # Plain block register write — big-endian on the wire
        # (ref device/mod.rs:73-83).
        v = data[0] if len(data) == 1 else (data[0] << 8) | data[1]
        self.sys_regs[(block, value)] = v
        return len(data)

    def read_bulk(self, endpoint, length, timeout_ms):
        if endpoint != C.BULK_IQ_ENDPOINT:
            raise UsbError(f"unexpected bulk endpoint {endpoint:#x}")
        if self.demod_regs.get((0, 0x19)) == 0x03:  # counter test mode
            # digital pattern, injected after the ADC input mux: the
            # direct-sampling swap below does not apply to it
            return self._counter.read(length)
        data = self._source.read(length)
        if decode_direct_sampling(self) == "on_swap":
            # OnSwap routes the Q ADC instead of I (demod reg (0,0x06) =
            # 0x90, ref rtlsdr.rs:308-315): the served I/Q pairs come out
            # swapped, i.e. the spectrum conjugated/mirrored.
            a = np.frombuffer(data, np.uint8).reshape(-1, 2)
            data = np.ascontiguousarray(a[:, ::-1]).tobytes()
        return data

    def get_usb_strings(self):
        return (self.spec.manufacturer, self.spec.product, self.spec.serial)

    def close(self) -> None:
        self.closed = True

    # -- I2C tunnel --------------------------------------------------------

    def _i2c_write(self, addr: int, data: bytes) -> None:
        if addr == C.EEPROM_ADDR:
            if len(data) >= 1:
                self._eeprom_ptr = data[0]
            for i, b in enumerate(data[1:]):
                self.eeprom[(self._eeprom_ptr + i) % C.EEPROM_SIZE] = b
            return
        if addr != self.tuner_i2c_addr:
            # nothing on the bus at this address: the transfer NAKs, the
            # control transfer fails (how a real probe of an absent chip
            # behaves; the driver's search_tuner logs and continues)
            raise UsbError(f"I2C NAK: no device at {addr:#x}")
        # Tuner write: first byte is the register address, rest is data
        # (ref r82xx.rs:1109-1136); a lone address byte sets the read pointer.
        if not data:
            return
        reg = data[0]
        if len(data) == 1:
            self._tuner_read_ptr = reg
            return
        for i, b in enumerate(data[1:]):
            if reg + i < len(self.tuner_regs):
                self.tuner_regs[reg + i] = b

    def _i2c_read(self, addr: int, length: int) -> bytes:
        if addr == C.EEPROM_ADDR:
            out = bytes(
                self.eeprom[(self._eeprom_ptr + i) % C.EEPROM_SIZE] for i in range(length)
            )
            self._eeprom_ptr = (self._eeprom_ptr + length) % C.EEPROM_SIZE
            return out
        if addr != self.tuner_i2c_addr:
            raise UsbError(f"I2C NAK: no device at {addr:#x}")
        # Tuner read from the current pointer.  Read-only regs 0..4 serve the
        # canned status bytes; RW regs echo what was written (raw wire bytes
        # are the bit-reverse of the logical values the driver caches, which
        # only matters to the driver, not to us).
        out = bytearray()
        for i in range(length):
            reg = self._tuner_read_ptr + i
            if reg < len(self._read_regs):
                out.append(self._read_regs[reg])
            elif reg < len(self.tuner_regs):
                out.append(bit_reverse_u8(self.tuner_regs[reg]))
            else:
                out.append(0)
        self._tuner_read_ptr += length  # chip auto-increments its pointer
        return bytes(out)


def dataclass_replace(spec: FakeDeviceSpec, **kw) -> FakeDeviceSpec:
    import dataclasses

    return dataclasses.replace(spec, **kw)


# ---------------------------------------------------------------------------
# Fake-device registry (merged into enumeration by tpu_sdr.control.transport)
# ---------------------------------------------------------------------------

_registry: list[FakeDeviceSpec] = []
_registry_lock = threading.Lock()


def register_fake_device(spec: FakeDeviceSpec | None = None) -> FakeDeviceSpec:
    """Make a simulated dongle visible to enumeration/open."""
    spec = spec or FakeDeviceSpec(serial=f"{len(_registry) + 1:08d}")
    with _registry_lock:
        _registry.append(spec)
    return spec


def clear_fake_devices() -> None:
    with _registry_lock:
        _registry.clear()


def fake_devices() -> list[FakeDeviceSpec]:
    with _registry_lock:
        return list(_registry)


def decode_direct_sampling(backend: "FakeUsbBackend") -> str:
    """Register-level direct-sampling state: the driver parks the tuner in
    its standby sequence (tuner reg 0x05 = 0xA0, r82xx.rs:619-636) when
    entering direct sampling and re-runs REG_INIT (0x05 = 0x83) when
    leaving; the I/Q ADC input swap shows in demod reg (0, 0x06) = 0x90
    (ref rtlsdr.rs:292-348)."""
    if backend.tuner_regs[0x05] != 0xA0:
        return "off"
    if backend.demod_regs.get((0, 0x06), 0x80) == 0x90:
        return "on_swap"
    return "on"


def decode_if_freq(backend: "FakeUsbBackend") -> int:
    """Invert the RTL2832U DDC IF registers (demod page 1, 0x19-0x1B; ref
    rtlsdr.set_if_freq <- rtlsdr.rs:178-192) into Hz."""
    from tpu_sdr.control.rtlsdr import DEF_RTL_XTAL_FREQ

    r19 = backend.demod_regs.get((1, 0x19), 0) & 0x3F
    r1a = backend.demod_regs.get((1, 0x1A), 0) & 0xFF
    r1b = backend.demod_regs.get((1, 0x1B), 0) & 0xFF
    v = (r19 << 16) | (r1a << 8) | r1b
    if v & (1 << 21):  # sign-extend 22 bits
        v -= 1 << 22
    return -round(v * DEF_RTL_XTAL_FREQ / (1 << 22))


def decode_tuned_freq(backend: "FakeUsbBackend") -> int:
    """Invert the R82xx PLL + RTL2832U DDC register state into the tuned
    RF frequency in Hz.

    This is the register-level ground truth for frequency-aware simulated
    sources: it reads ONLY what the driver actually wrote —
    tuner regs 0x10 (mixer divider), 0x14 (Nint as 4*Ni2c + Si2c + 13),
    0x15/0x16 (SDM fraction, gated by the 0x12 power-down bit), and demod
    page-1 0x19-0x1b (DDC IF as a signed 22-bit fraction of the RTL
    xtal) — and reverses r82xx.set_pll / rtlsdr.set_if_freq exactly:

        vco = 2*pll_ref*Nint + 2*pll_ref*sdm/65536
        lo  = vco / mix_div
        rf  = lo - if_freq           (set_freq: lo = rf + int_freq)

    The fake's I2C tunnel is address-aware: plain boards simulate the
    R820T at 0x34, Blog-V4 boards the R828D at 0x74 (the 0x34 probe NAKs
    like real hardware).  Either way the fake serves ``vco_fine_tune ==
    vco_power_ref`` for the probed chip, so the driver's div_num
    adjustment is 0 and the same inversion covers both.  SDM resolution
    bounds the round trip to ~2*pll_ref/65536/mix_div Hz (<1 kHz
    everywhere).  Known limitation: the V4 upconverter below 28.8 MHz is
    not inverted (the decoded frequency is the post-upconvert LO input).
    """
    from tpu_sdr.control.rtlsdr import DEF_RTL_XTAL_FREQ

    if decode_direct_sampling(backend) != "off":
        # Tuner bypassed: tuning is DDC-only (set_center_freq ->
        # set_if_freq(freq), ref rtlsdr.rs:165-167) and the PLL registers
        # are stale.
        return decode_if_freq(backend)

    pll_ref = DEF_RTL_XTAL_FREQ

    regs = backend.tuner_regs
    div_num = (regs[0x10] >> 5) & 0x07
    mix_div = 2 << div_num

    b14 = regs[0x14]
    si = (b14 >> 6) & 0x03
    ni = b14 & 0x3F
    nint = 4 * ni + si + 13

    if regs[0x12] & 0x08:  # SDM powered down: integer-N mode
        sdm = 0
    else:
        sdm = regs[0x15] | (regs[0x16] << 8)
    vco = 2 * pll_ref * nint + (2 * pll_ref * sdm) // 65536
    lo = vco // mix_div

    return lo - decode_if_freq(backend)


def decode_sample_rate(backend: "FakeUsbBackend") -> int:
    """Invert the resampler-ratio registers (demod page 1, 0x9F hi /
    0xA1 lo; rtlsdr.set_sample_rate <- ref rtlsdr.rs:217-265) into the
    actual sample rate in Hz.  2.048 Msps before any rate was set."""
    from tpu_sdr.control.rtlsdr import DEF_RTL_XTAL_FREQ

    hi = backend.demod_regs.get((1, 0x9F), 0) & 0xFFFF
    lo = backend.demod_regs.get((1, 0xA1), 0) & 0xFFFF
    ratio = (hi << 16) | lo
    if ratio == 0:
        return 2_048_000
    real_ratio = ratio | ((ratio & 0x08000000) << 1)
    return int(DEF_RTL_XTAL_FREQ * (1 << 22) / real_ratio)


class StationSource(SampleSource):
    """Stations at ABSOLUTE frequencies.

    Each ``read`` decodes the dongle's CURRENT tuned frequency and sample
    rate from the register state the driver actually programmed
    (:func:`decode_tuned_freq` / :func:`decode_sample_rate`) and
    synthesizes the baseband an antenna would deliver: every station
    within the captured span appears at its true offset, with per-station
    carrier-phase and modulation continuity across reads and retunes.
    Makes the simulator frequency-selective — tune elsewhere and a
    station genuinely disappears — which is what scan-mode tests need.

    ``stations``: iterable of ``(freq_hz, audio_freq_hz, deviation_hz)``
    WBFM stations (mono tone program), optionally extended to
    ``(freq_hz, audio_freq_hz, deviation_hz, t_on_s, t_off_s)`` — the
    station transmits only while antenna time (seconds of samples served)
    is inside ``[t_on, t_off)``.  Finite transmissions are what
    squelch-driven scan tests need: the scanner must leave a station when
    its carrier drops.
    """

    def __init__(self, stations, amplitude: float = 0.4,
                 noise_std: float = 0.004, seed: int = 0):
        self.stations = []
        for s in stations:
            s = tuple(s)
            if len(s) == 3:
                s = s + (0.0, float("inf"))
            self.stations.append(s)
        self.amplitude = amplitude
        self.noise_std = noise_std
        self._rng = np.random.default_rng(seed)
        self._carrier_ph = [0.0] * len(self.stations)
        self._mod_ph = [0.0] * len(self.stations)
        self._samples = 0  # antenna time base, survives retunes
        self._backend: FakeUsbBackend | None = None

    def attach(self, backend: "FakeUsbBackend") -> None:
        self._backend = backend

    def read(self, length: int) -> bytes:
        n = length // 2
        assert self._backend is not None, "source not attached to a backend"
        tuned = decode_tuned_freq(self._backend)
        rate = decode_sample_rate(self._backend)

        sig_re = self._rng.normal(0.0, self.noise_std, n)
        sig_im = self._rng.normal(0.0, self.noise_std, n)
        t = (self._samples + np.arange(n)) / rate  # antenna time, s
        self._samples += n
        for idx, (f_st, f_audio, dev, t_on, t_off) in enumerate(
                self.stations):
            offset = f_st - tuned
            if abs(offset) > 0.5 * rate:
                continue  # outside the captured span
            audio = np.sin(self._mod_ph[idx]
                           + 2 * np.pi * f_audio / rate * np.arange(n))
            self._mod_ph[idx] = float(
                (self._mod_ph[idx] + 2 * np.pi * f_audio / rate * n)
                % (2 * np.pi))
            inst = offset + dev * audio  # instantaneous frequency, Hz
            ph = self._carrier_ph[idx] + 2 * np.pi / rate * np.cumsum(inst)
            self._carrier_ph[idx] = float(ph[-1] % (2 * np.pi))
            on = ((t >= t_on) & (t < t_off)).astype(np.float64)
            sig_re += self.amplitude * on * np.cos(ph)
            sig_im += self.amplitude * on * np.sin(ph)

        u8 = np.empty(2 * n, np.uint8)
        u8[0::2] = np.clip(np.round(127.5 + 127.0 * sig_re), 0, 255)
        u8[1::2] = np.clip(np.round(127.5 + 127.0 * sig_im), 0, 255)
        return u8.tobytes()
