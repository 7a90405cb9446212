"""What the drivers share: the program's parameters and launch counters,
and the verdict."""

from __future__ import annotations


def demod_params(known: dict, sample_rate: float):
    """The program's DemodParams of a configuration's known parameters."""
    import urh_tpu_torch as ut

    return ut.DemodParams(modulation=known["modulation"],
                          samples_per_symbol=known["samples_per_symbol"], center=known["center"],
                          noise_threshold=known["noise_threshold"], tolerance=known["tolerance"],
                          pause_threshold=known["pause_threshold"], sample_rate=sample_rate)


def bits_text(bits: bytes) -> str:
    """Bits as bytes of 0 and 1 -> a '0'/'1' string."""
    return bytes(b + 48 for b in bits).decode()


def _counters() -> dict:
    from urh_tpu_torch.ai import median_kernels
    from urh_tpu_torch.dsp import costas, fused_kernels, stream_kernels
    from urh_tpu_torch.protocol import stream

    return {"LAUNCHES": {**fused_kernels.LAUNCHES, **stream_kernels.LAUNCHES,
                         **costas.LAUNCHES, **median_kernels.LAUNCHES},
            "ALIGNMENT_COPIES": fused_kernels.ALIGNMENT_COPIES,
            "stream.FALLBACKS": stream.FALLBACKS, "stream.HOST_ROUTE": stream.HOST_ROUTE}


def reset_launches() -> dict:
    """Snapshot of the program's launch counters at the window's start."""
    return {group: dict(c) for group, c in _counters().items()}


def read_launches(start: dict) -> dict:
    """The counters' increase since ``start``: which kernels and routes the
    window drove."""
    now = _counters()
    return {group: {k: v - start[group].get(k, 0) for k, v in c.items()}
            for group, c in now.items()}


def sequence_mismatch(got: list, want: list) -> int:
    """Answers that differ, position by position, plus those missing or extra."""
    same = sum(a == b for a, b in zip(got, want))
    return max(len(got), len(want)) - same


def verdict(numbers: dict, limits: dict, attempted: int, failed: int) -> dict:
    """correct: something was attempted and every number is at or under its
    limit (a number the limits name and the run could not give fails)."""
    missing = [k for k in limits if k not in numbers]
    for k in missing:
        numbers[k] = float("inf")
    correct = attempted > 0 and all(numbers[k] <= limits[k] for k in limits)
    return {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "numbers": {k: (numbers[k], limits[k]) for k in limits}}
