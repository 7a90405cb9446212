"""Build of the CUDA kernels with nvcc, loaded through ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so nvcc builds them in seconds, one process a source, all at once.  The library lands in
``build/urh_tpu_torch/`` beside the package, named by a hash of the
sources and flags, and is built at first use in each checkout.  Nothing
here runs at import time: the CPU tests import every module on a machine
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

from urh_tpu_torch.util.logging import logger

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "urh_tpu_torch")
_SOURCES = ["fused_demod.cu", "fused_demod.cuh", "costas.cu", "costas.cuh",
            "stream_block.cu", "stream_block.cuh", "median_filter.cu", "median_filter.cuh",
            "iir_feedback.cu", "iir_feedback.cuh"]

# numerics-relevant flags are part of the cache key.  No --use_fast_math:
# K3 parity needs the IEEE sqrtf and division, and the Costas loop the
# full-accuracy sincosf (the median filter compares integers only);
# the IIR feedback's products and sums round one by one, as its plain loop's;
# -fmad=false keeps every product rounded as the separate PyTorch ops round
# it.
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_C_FLOAT, _C_INT, _C_INT64, _PTR = ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
# launcher name -> argtypes (pointers and the stream as c_void_p).
# _SIGNATURES holds fused_demod.cu's.
_SIGNATURES = {
    "urh_fsk_f32": [_PTR, _C_INT64, _C_FLOAT, _C_FLOAT, _PTR, _PTR, _PTR],
    "urh_fsk_i8": [_PTR, _C_INT64, _C_FLOAT, _C_FLOAT, _C_INT, _PTR, _PTR],
    "urh_ask_f32": [_PTR, _C_INT64, _C_FLOAT, _C_FLOAT, _C_FLOAT, _PTR, _PTR, _PTR],
    "urh_ask_i8": [_PTR, _C_INT64, _C_INT, _C_INT, _C_INT, _PTR, _PTR],
}
# costas.cu's, stream_block.cu's, median_filter.cu's and iir_feedback.cu's
_STREAM_SIGNATURES = {
    "urh_costas_f32": [_PTR, _C_INT64, _C_FLOAT, _C_FLOAT, _C_FLOAT, _C_INT, _C_FLOAT,
                       _C_FLOAT, _PTR, _PTR, _PTR],
    "urh_costas_batch_f32": [_PTR, _C_INT64, _C_INT64, _C_FLOAT, _C_FLOAT, _C_FLOAT, _C_INT,
                             _C_FLOAT, _C_FLOAT, _PTR, _PTR, _PTR],
    # not a launcher: the batch's streams an SM holds at once
    "urh_costas_batch_resident": [_C_INT, _PTR],
    "urh_costas_sincos_f32": [_PTR, _C_INT64, _PTR, _PTR, _PTR, _PTR, _PTR],
    **{f"urh_stream_block_{t}": [_PTR, _C_INT64, _C_INT, _C_FLOAT, _C_FLOAT, _C_INT, _PTR,
                                 _C_INT, _C_INT64, _C_INT, _PTR, _PTR]
       for t in ("f32", "i8")},
    **{f"urh_stream_states_{t}": [_PTR, _C_INT64, _C_INT, _C_FLOAT, _C_FLOAT, _C_INT, _PTR,
                                  _C_INT, _PTR, _PTR]
       for t in ("f32", "i8")},
    "urh_median_filter_f32": [_PTR, _C_INT64, _C_INT64, _C_INT64, _PTR, _PTR],
    # not a launcher: which kernel a window k takes (and its registers)
    "urh_median_filter_variant": [_C_INT64, _PTR, _PTR, _PTR, _PTR],
    "urh_iir_feedback_f32": [_PTR, _C_INT64, _PTR, _C_INT, _PTR, _PTR],
    # not a launcher of the filter: the chain step's latency in SM cycles
    "urh_iir_chain_cycles": [_PTR, _C_INT64, _PTR, _PTR, _PTR],
}
# the one launcher-side helper that returns a size, not a CUDA error
_WORK_WORDS = ("urh_stream_block_work_words", [_C_INT64, _C_INT64, _C_INT])

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the urh_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernel library if this checkout has not yet; -> .so path.
    One nvcc a source, all started together, then one link."""
    path = os.path.join(BUILD_DIR, f"libfused_demod_{_source_hash()}.so")
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path[:-3]}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    compile_flags = [f for f in FLAGS if f != "-shared"]
    units = [(os.path.join(_SRC_DIR, name), f"{tmp}.{name[:-3]}.o")
             for name in _SOURCES if name.endswith(".cu")]
    objs = [obj for _, obj in units]
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", obj, src])
             for src, obj in units]
    try:
        for proc in procs:
            if proc.wait(timeout=600):
                raise subprocess.CalledProcessError(proc.returncode, proc.args)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    subprocess.run([_nvcc(), *FLAGS, "-o", f"{tmp}.so", *objs], check=True, timeout=600)
    for obj in objs:
        os.remove(obj)
    os.replace(f"{tmp}.so", path)  # atomic: concurrent builders never load a partial file
    logger.info("built %s in %.1f s", os.path.basename(path),
                time.perf_counter() - t0)
    return path


def library() -> ctypes.CDLL:
    """ctypes handle to the kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in {**_SIGNATURES, **_STREAM_SIGNATURES}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        fn = getattr(lib, _WORK_WORDS[0])
        fn.argtypes, fn.restype = _WORK_WORDS[1], _C_INT64
        _lib = lib
    return _lib
