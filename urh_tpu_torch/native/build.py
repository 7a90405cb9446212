"""On-demand g++ build + ctypes loading of the native host library.

The library lands in ``build/urh_tpu_torch/native/`` beside the package,
named by a hash of the flags and sources, and is built at first use in
each checkout.  Several processes may build it at once (test workers), so
each compiles to a file of its own and moves it into place atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from urh_tpu_torch.util.logging import logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "native", "src")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "urh_tpu_torch", "native")
_SOURCES = ["ringbuffer.cpp", "net_io.cpp", "dsp_kernels.cpp"]

_lib = None
_build_failed = False


# numerics-relevant flags are part of the cache key: a flag-only change
# (e.g. -ffp-contract) must invalidate previously cached builds
_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
          "-pthread", "-fopenmp"]


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the native library if this checkout has not yet; -> .so path."""
    path = os.path.join(BUILD_DIR, "liburh_tpu_torch_native_{}.so".format(_source_hash()))
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path[:-3]}.{os.getpid()}.tmp"
    sources = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    # -ffp-contract=off: the DSP kernels are exactness-tested against
    # their NumPy twins, which never fuse multiply-adds
    cmd = ["g++"] + _FLAGS + ["-o", tmp] + sources
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def get_library():
    """ctypes handle to the native library, or None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native library unavailable: {}".format(e))
        _build_failed = True
        return None
    lib.urh_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.urh_ring_size_bytes.argtypes = [ctypes.c_uint64]
    lib.urh_ring_size_bytes.restype = ctypes.c_uint64
    lib.urh_ring_len.argtypes = [ctypes.c_void_p]
    lib.urh_ring_len.restype = ctypes.c_uint64
    lib.urh_ring_space.argtypes = [ctypes.c_void_p]
    lib.urh_ring_space.restype = ctypes.c_uint64
    lib.urh_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.urh_ring_push.restype = ctypes.c_uint64
    lib.urh_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.urh_ring_pop.restype = ctypes.c_uint64
    lib.urh_ring_clear.argtypes = [ctypes.c_void_p]

    lib.urh_net_rx_start.argtypes = [ctypes.c_void_p, ctypes.c_uint16]
    lib.urh_net_rx_start.restype = ctypes.c_void_p
    lib.urh_net_rx_port.argtypes = [ctypes.c_void_p]
    lib.urh_net_rx_port.restype = ctypes.c_uint16
    lib.urh_net_rx_total_samples.argtypes = [ctypes.c_void_p]
    lib.urh_net_rx_total_samples.restype = ctypes.c_uint64
    lib.urh_net_rx_dropped_samples.argtypes = [ctypes.c_void_p]
    lib.urh_net_rx_dropped_samples.restype = ctypes.c_uint64
    lib.urh_net_rx_stop.argtypes = [ctypes.c_void_p]
    lib.urh_net_send.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                 ctypes.c_void_p, ctypes.c_uint64]
    lib.urh_net_send.restype = ctypes.c_int64

    lib.urh_afp_demod_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.urh_median_full_windows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_void_p]
    lib.urh_mag_squared_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p]
    lib.urh_block_states_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_float,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p]
    lib.urh_rle_i8.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.urh_rle_i8.restype = ctypes.c_int64
    lib.urh_median_sliding.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_void_p]

    _lib = lib
    return _lib


def is_available() -> bool:
    return get_library() is not None
