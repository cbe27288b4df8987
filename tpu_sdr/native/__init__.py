"""Native host runtime bindings (ctypes over ``csrc/tpusdr_io.cpp``).

The reference's acquisition runtime is native Rust (reader threads + bounded
channels, /root/reference/examples/simple_fm.rs:55-132 and
rtl_tcp.rs:334-502).  This package binds the framework's C++ equivalent: a
fixed-block ring buffer with backpressure/drop accounting, an fd reader pump
thread, and the hot host-side byte conversions.

The shared library is compiled on demand with ``g++`` (no pybind11 in this
environment; plain C ABI + ctypes) into ``_build/``, under a file name keyed
by a hash of the source, the compiler and its flags — so a library is
only ever loaded by a tree whose sources built it, and a copied tree with
other sources rebuilds instead of loading a stale binary.  The flags are
portable (no ``-march=native``): the binary may run on another host's CPU
than the one that built it.  Everything degrades gracefully:
``available()`` is False when the toolchain or binary is missing or stale,
and callers fall back to pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_LIB_DIR = os.path.join(os.path.dirname(__file__), "_build")
_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc", "tpusdr_io.cpp")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def build_key(source: bytes, cxx: str, flags=CXXFLAGS) -> str:
    """Content key of one build: source bytes, compiler and flags."""
    h = hashlib.sha256(source)
    h.update("\0".join((cxx,) + tuple(flags)).encode())
    return h.hexdigest()[:16]


def lib_path(key: str) -> str:
    return os.path.join(_LIB_DIR, f"libtpusdr_io-{key}.so")


def _build(cxx: str, out: str) -> bool:
    if shutil.which(cxx) is None:
        return False
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = [cxx, *CXXFLAGS, os.path.abspath(_SRC), "-o", tmp, "-lpthread"]
    if subprocess.run(cmd, capture_output=True).returncode != 0:
        return False
    os.replace(tmp, out)
    return True


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.tsdr_ring_create.restype = c.c_void_p
    lib.tsdr_ring_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.tsdr_ring_destroy.argtypes = [c.c_void_p]
    lib.tsdr_ring_push.restype = c.c_int
    lib.tsdr_ring_push.argtypes = [c.c_void_p, c.c_char_p]
    lib.tsdr_ring_pop.restype = c.c_int
    lib.tsdr_ring_pop.argtypes = [c.c_void_p, c.c_void_p, c.c_int]
    lib.tsdr_ring_count.restype = c.c_size_t
    lib.tsdr_ring_count.argtypes = [c.c_void_p]
    lib.tsdr_ring_dropped.restype = c.c_uint64
    lib.tsdr_ring_dropped.argtypes = [c.c_void_p]
    lib.tsdr_ring_set_eof.argtypes = [c.c_void_p]
    lib.tsdr_ring_eof.restype = c.c_int
    lib.tsdr_ring_eof.argtypes = [c.c_void_p]
    lib.tsdr_pump_start.restype = c.c_void_p
    lib.tsdr_pump_start.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int]
    lib.tsdr_pump_stop.argtypes = [c.c_void_p]
    lib.tsdr_pump_blocks.restype = c.c_uint64
    lib.tsdr_pump_blocks.argtypes = [c.c_void_p]
    lib.tsdr_u8_iq_to_planar_f32.argtypes = [
        c.c_void_p, c.c_size_t, c.c_int, c.c_float, c.c_void_p, c.c_void_p]
    lib.tsdr_rotate_fs4_u8.argtypes = [
        c.c_void_p, c.c_void_p, c.c_size_t, c.c_int]
    lib.tsdr_f32_to_s16.argtypes = [c.c_void_p, c.c_size_t, c.c_float, c.c_void_p]
    lib.tsdr_count_pattern_breaks.restype = c.c_uint64
    lib.tsdr_count_pattern_breaks.argtypes = [
        c.c_void_p, c.c_size_t, c.POINTER(c.c_int)]
    lib.tsdr_parse_tcp_commands.restype = c.c_size_t
    lib.tsdr_parse_tcp_commands.argtypes = [
        c.c_void_p, c.c_size_t, c.c_void_p, c.c_void_p, c.c_size_t]


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TPU_SDR_NO_NATIVE") or not os.path.exists(_SRC):
            return None
        cxx = os.environ.get("CXX", "g++")
        with open(_SRC, "rb") as f:
            path = lib_path(build_key(f.read(), cxx))
        if not os.path.exists(path) and not _build(cxx, path):
            return None
        _lib = open_library(path)
        return _lib


def open_library(path: str) -> ctypes.CDLL | None:
    """dlopen ``path`` and declare its ABI; None if it cannot be opened or
    lacks a symbol this module declares."""
    try:
        lib = ctypes.CDLL(path)
        _declare(lib)
    except (OSError, AttributeError):
        return None
    return lib


def available() -> bool:
    return load() is not None


from tpu_sdr.native.io import (  # noqa: E402,F401
    NativePump,
    NativeRing,
    count_pattern_breaks,
    f32_to_s16,
    parse_tcp_commands,
    rotate_fs4_u8,
    u8_iq_to_planar_f32,
)
