"""The native library is keyed by what built it, and a library that cannot
serve this tree's ABI degrades to the numpy paths instead of crashing."""

import ctypes.util
import os

import pytest

import tpu_sdr.native as native

SRC = b"int tsdr_version() { return 1; }\n"


@pytest.mark.parametrize("change", [
    dict(source=SRC + b"// edited\n"),
    dict(cxx="clang++"),
    dict(flags=native.CXXFLAGS + ("-march=native",)),
])
def test_build_key_changes_with_what_built_it(change):
    base = dict(source=SRC, cxx="g++", flags=native.CXXFLAGS)
    assert native.build_key(**base) == native.build_key(**base)
    assert native.build_key(**{**base, **change}) != native.build_key(**base)


def test_library_path_carries_the_key():
    key = native.build_key(SRC, "g++")
    path = native.lib_path(key)
    assert key in os.path.basename(path) and path.endswith(".so")


def test_portable_flags():
    assert not any("march" in f for f in native.CXXFLAGS)


def test_library_lacking_the_abi_is_refused():
    libm = ctypes.util.find_library("m")
    if libm is None:
        pytest.skip("no libm to stand in for a stale library")
    assert native.open_library(libm) is None  # AttributeError, not a crash


def test_missing_library_is_refused(tmp_path):
    assert native.open_library(str(tmp_path / "absent.so")) is None
