#!/usr/bin/env python3
"""Where estimate() spends its time, stage by stage, on a card.

    python3 tools/estimate_stages.py     # from the repository root, one CUDA card

A one-off measurement; nothing in the package depends on it.  On
chip_smoke.py's estimated captures (the 2^24-sample FSK and ASK captures,
float32 and int8, the 2^22-sample BPSK capture and bench.py's estimate
capture) it runs urh_tpu_torch.ai.estimate's stages one after another,
as estimate() runs them, each ended by torch.cuda.synchronize() and timed
by the host clock: the magnitudes and the noise floor, segmentation, the
upload of the capture, classification (width buckets on the card, scalars
back), afp_demod with the rectangular signal's copy back, the per-message
scans (center with its histogram on the card, plateaus, tolerance, bit
length) and the vote.  Each capture runs twice and the second run is
printed, with the whole estimate() call timed alone beside it.  Then
torch.profiler over one classification call: device time by kernel name
and the card's busy share of the call.  Last, the card's name and power
limit.
"""

from __future__ import annotations

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def stages(iq: np.ndarray) -> dict:
    """estimate()'s stages on the default device -> seconds by stage."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.ai import estimate as est
    from urh_tpu_torch.ai import segmentation as seg
    from urh_tpu_torch.dsp import demod

    out, t0 = {}, time.perf_counter()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - t0
        t0 = now

    data = ut.IQData(iq)
    magnitudes = data.magnitudes
    noise = seg.detect_noise_level(magnitudes)
    mark("magnitudes and noise floor")
    segments = seg.segment_messages_from_magnitudes(magnitudes, noise)
    mark("segmentation")
    staged = data.staged_planes(None)
    mark("upload")
    modulation = est.detect_modulation_for_messages(data, segments, staged=staged)
    mark("classification")
    if modulation == "OOK":
        segments = seg.merge_message_segments_for_ook(segments)
    kind = "ASK" if modulation in ("OOK", "ASK") else modulation
    rect = demod.afp_demod(staged, noise, kind, 2, dtype=iq.dtype).cpu().numpy()
    mark("afp_demod and copy back")
    results = [est._message_parameters(rect[a:b]) for a, b in segments]
    mark(f"per-message scans ({len(segments)} messages)")
    centers = [c for c, _, _ in results if c is not None]
    est.get_most_frequent_value([b for _, b, _ in results if b is not None])
    np.mean(centers)
    mark("vote")
    return out


def profile_classification(iq: np.ndarray):
    import urh_tpu_torch as ut
    from urh_tpu_torch.ai import estimate as est
    from urh_tpu_torch.ai import segmentation as seg

    data = ut.IQData(iq)
    magnitudes = data.magnitudes
    segments = seg.segment_messages_from_magnitudes(magnitudes,
                                                    seg.detect_noise_level(magnitudes))
    staged = data.staged_planes(None)
    est.detect_modulation_for_messages(data, segments, staged=staged)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        est.detect_modulation_for_messages(data, segments, staged=staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"classification of {len(segments[:100])} messages: wall {wall} s, device busy "
          f"{busy} s ({busy / wall:.1%} of the call)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.key[:70]}: {e.self_device_time_total / 1e3} ms, {e.count} calls",
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("estimate_stages.py needs a CUDA card; none is available")
    import urh_tpu_torch as ut

    captures = chip_smoke.estimate_captures(chip_smoke.N_FULL,
                                            dict(n=chip_smoke.B5_TIMED_N, seed=13))
    for label, iq, *_ in captures:
        for _ in range(2):
            times = stages(iq)
        t0 = time.perf_counter()
        ut.estimate(iq)
        whole = time.perf_counter() - t0
        print(f"{label} ({len(iq)} samples): estimate() {whole} s; stages (s): " + "; ".join(
            f"{name} {t}" for name, t in times.items()), flush=True)
    profile_classification(captures[0][1])
    print(chip_smoke.card_identity())


if __name__ == "__main__":
    main()
