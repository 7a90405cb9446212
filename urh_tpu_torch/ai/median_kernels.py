"""The forward-window median filter (B7) as a CUDA kernel.

Port of urh_tpu.ai.device._median_full_windows_jax and
_median_filtered_jax (XLA programs: a min/max network over k shifted views,
plus a sort a column for the k - 1 shrunk tail windows).  ``out[r, i]`` is
the median of ``rows[r, i : min(i + k, W)]``: the value at index ``kk // 2``
of the window's ``kk`` sorted values, the upper median where ``kk`` is even,
as urh_tpu takes it.  The kernel (``csrc/median_filter.cu``, selection in
``csrc/median_filter.cuh``) gives a thread a run of consecutive outputs
for k up to 16 (the keys their windows share sorted once, each output
merged from them; a sliding sorted window where the row ends) and runs a
rank count a window above; the plain version here sorts the windows.  Both
order the values by one total order (-0.0 below +0.0, NaN last) held by
integer keys, so they agree to the bit on every input.  ``torch.median`` is no substitute: it takes the lower median
of an even count and has no shrunk windows.

:func:`median_filter` launches the kernel for a CUDA tensor (counted in
:data:`LAUNCHES`) and runs :func:`median_filter_plain` for a CPU one.
"""

from __future__ import annotations

import ctypes

import torch

from urh_tpu_torch import _build

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"median_filter_f32": 0}

NAN_KEY = 0x7FC00000  # URH_MEDIAN_NAN_KEY: every NaN, above +inf
_SIGN_FLIP = 0x7FFFFFFF
_PAD_KEY = 0x7FFFFFFF  # above every key: pads a shrunk window to k


def median_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in the filter's total order (urh_median_key)."""
    bits = x.view(torch.int32)
    keys = torch.where(bits < 0, bits ^ _SIGN_FLIP, bits)
    return keys.masked_fill(torch.isnan(x), NAN_KEY)


def median_values(keys: torch.Tensor) -> torch.Tensor:
    """int32 keys -> float32 (urh_median_value)."""
    return torch.where(keys < 0, keys ^ _SIGN_FLIP, keys).view(torch.float32)


def _check(rows: torch.Tensor, k: int) -> bool:
    """Validate the inputs; True for a CUDA tensor, False for a CPU one."""
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.float32:
        raise TypeError("expected float32 rows as a torch.Tensor")
    if rows.dim() == 0 or not rows.is_contiguous():
        raise ValueError("expected contiguous rows of at least one dimension")
    if int(k) < 1:
        raise ValueError(f"the window must hold at least one value, got k={k}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return rows.device.type == "cuda"


def median_filter_plain(rows: torch.Tensor, k: int) -> torch.Tensor:
    """The filter by sorting: every window of the keys, padded at the row's
    end by k - 1 keys above all others so that a shrunk window of kk values
    keeps them in its first kk places, sorted, and the place kk // 2 taken."""
    w = rows.shape[-1]
    flat = rows.reshape(-1, w)
    kk = min(int(k), w)
    if flat.numel() == 0:
        return rows.clone()
    pad = torch.full((flat.shape[0], kk - 1), _PAD_KEY, dtype=torch.int32, device=rows.device)
    keys = torch.cat((median_keys(flat), pad), dim=1)
    ordered = keys.unfold(1, kk, 1).sort(dim=-1).values  # (R, W, kk)
    place = torch.arange(w, 0, -1, device=rows.device).clamp(max=kk) // 2
    picked = ordered.gather(-1, place.expand(flat.shape[0], w)[..., None])[..., 0]
    return median_values(picked).reshape(rows.shape)


def kernel_variant(k: int) -> dict:
    """The CUDA kernel the window k (already clamped to the row) takes, as
    the built library reports it: ``variant`` "window" or "rank count",
    consecutive ``outputs`` a thread takes at a time, ``block_outputs``,
    and ``registers`` and ``local_bytes`` a thread.  Builds the library
    (needs the card's toolkit)."""
    ints = [ctypes.c_int() for _ in range(4)]
    code = _build.library().urh_median_filter_variant(int(k), *(ctypes.byref(v) for v in ints))
    if code < 0:
        raise RuntimeError(f"no kernel attributes for the median filter at k={k}")
    outputs, block_outputs, registers, local_bytes = (v.value for v in ints)
    return {"variant": "window" if code else "rank count", "outputs": outputs,
            "block_outputs": block_outputs, "registers": registers, "local_bytes": local_bytes}


def median_filter(rows: torch.Tensor, k: int) -> torch.Tensor:
    """Forward-window median of each row (the last dimension) of a
    contiguous float32 tensor -> a float32 tensor of the same shape."""
    if not _check(rows, k):
        return median_filter_plain(rows, k)
    w = rows.shape[-1]
    out = torch.empty_like(rows)
    if rows.numel():
        fn = _build.library().urh_median_filter_f32
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            rc = fn(rows.data_ptr(), rows.numel() // w, w, min(int(k), w), out.data_ptr(),
                    stream)
        if rc != 0:
            raise RuntimeError(f"urh_median_filter_f32 launch failed with CUDA error {rc}")
        LAUNCHES["median_filter_f32"] += 1
    return out
