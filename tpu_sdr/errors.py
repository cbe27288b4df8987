"""Error layer for tpu-sdr.

Re-design of the reference's error layer
(/root/reference/src/error.rs:11-44): the reference generates an enum with
``Usb(rusb::Error)`` and ``RtlsdrErr(String)`` variants via a macro.  Here we
use a small exception hierarchy instead — idiomatic Python — while keeping the
same two error classes so call sites map one-to-one.
"""

from __future__ import annotations


class RtlSdrError(Exception):
    """Base error for all tpu-sdr failures (ref: src/error.rs:40-44)."""


class UsbError(RtlSdrError):
    """Transport-level USB failure (ref: src/error.rs:42 ``Usb(rusb::Error)``).

    ``code`` carries the libusb error code when raised by the libusb backend.
    """

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        self.code = code


class DeviceNotFoundError(RtlSdrError):
    """No matching device during enumeration/open (ref: device_handle.rs:88-93)."""


class InvalidConfigError(RtlSdrError):
    """Rejected configuration value, e.g. out-of-range sample rate
    (ref: src/rtlsdr.rs:219-221)."""


class PllError(RtlSdrError):
    """No valid PLL parameters for the requested frequency
    (ref: src/tuners/r82xx.rs:741-746)."""
