"""The controls' lower precisions: the nearest below the one a
configuration states.  float32 samples go to bfloat16 (8 bits of
mantissa, round to nearest even), and every float32 intermediate of the
demodulation with them; int8 samples go to int4 (the value over 16,
rounded and clipped to [-8, 7], on the same scale)."""

from __future__ import annotations

import numpy as np


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16, as float32."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    out = rounded.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), out, x).astype(np.float32)


def int4(x: np.ndarray) -> np.ndarray:
    """int8 samples at int4 precision, on the int8 scale."""
    q = np.clip(np.rint(np.asarray(x, np.float32) / 16.0), -8, 7)
    return (q * 16).astype(np.int8)


def lower(sample_format: str):
    """-> (a function of the samples, a rounding for the arithmetic) that
    put a configuration's control one precision below its samples'."""
    if sample_format == "float32":
        return (lambda x: x), bf16
    if sample_format == "int8":
        return int4, None
    raise ValueError(f"no lower precision for {sample_format!r}")
