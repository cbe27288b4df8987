"""tpu-sdr — a software-defined-radio framework with a JAX data plane.

Re-designs the capabilities of the ``rtl-sdr-rs`` reference
(/root/reference) for an accelerator: host-side device control plane (USB
register protocol, R82xx tuner logic, enumeration) plus a JAX/XLA DSP data
plane (WBFM receive chain, channelizers, sharded multi-device streaming).

Public API mirrors the reference facade (/root/reference/src/lib.rs).
"""

DEFAULT_BUF_LENGTH = 16 * 16384  # bytes per sync-read block (ref src/lib.rs:25)

# Platform pinning before any backend starts: TPU_SDR_PLATFORM=cpu keeps a
# process off the accelerator (the config route; applied at import).
import os as _os  # noqa: E402

if _os.environ.get("TPU_SDR_PLATFORM"):
    import jax as _jax  # noqa: E402

    _jax.config.update("jax_platforms", _os.environ["TPU_SDR_PLATFORM"])

from tpu_sdr.errors import (  # noqa: E402,F401
    DeviceNotFoundError,
    InvalidConfigError,
    PllError,
    RtlSdrError,
    UsbError,
)
from tpu_sdr.api import (  # noqa: E402,F401
    DeviceId,
    DirectSampleMode,
    RtlSdr,
    Sensor,
    SensorValue,
    TunerGain,
    TunerId,
    get_device_count,
    get_device_info,
    get_device_serial,
    list_devices,
)
from tpu_sdr.control.usb import DeviceDescriptor  # noqa: E402,F401
