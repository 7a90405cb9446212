"""Length-field inference.

Behavioral contract: urh/awre/engines/LengthEngine.py — a length field
is a window that (a) is constant within each same-length message
cluster, (b) differs across clusters, and (c) decodes to a value close
to the cluster's message length in n-grams.

Dataflow here: cluster messages by n-gram count, get each cluster's
constant windows from the device histogram, then score every aligned
(start, window-size, byte-order) combination of every candidate in one
vectorized pass and pick the window size that wins across the most
clusters.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

import numpy as np

from urh_tpu_torch.awre.common_range import CommonRange
from urh_tpu_torch.awre.engines.engine import Engine
from urh_tpu_torch.awre.kernels import bit_array_to_number


def _window_value(bits: np.ndarray, byteorder: str) -> int:
    value = bit_array_to_number(bits, len(bits))
    if byteorder == "little" and len(bits) > 8 and len(bits) % 8 == 0:
        value = int.from_bytes(value.to_bytes(len(bits) // 8, "big"), "little")
    return value


def _closeness(value: float, target: float, sigma: float = 2.0) -> float:
    return float(np.exp(-0.5 * ((value - target) / sigma) ** 2))


def _score_window(bits: np.ndarray, target: int, position: int,
                  byteorder: str = "big") -> float:
    # length fields live near the front: damp scores at large positions
    return _closeness(_window_value(bits, byteorder), target) / (1 + 0.25 * position)


class LengthEngine(Engine):
    def __init__(self, bitvectors, already_labeled=None, device=None):
        self.bitvectors = bitvectors
        self.device = device
        self.already_labeled = [] if already_labeled is None else already_labeled

    def find(self, n_gram_length=8, minimum_score=0.1):
        clusters = defaultdict(list)
        for i, bv in enumerate(self.bitvectors):
            clusters[int(math.ceil(len(bv) / n_gram_length))].append(i)

        candidates = {
            size: self.ignore_already_labeled(ranges, self.already_labeled)
            for size, ranges in self.find_common_ranges_by_cluster(
                self.bitvectors, clusters, alpha=0.7, device=self.device).items()
        }
        self._drop_cross_cluster_constants(candidates)

        scored = self._score_all_windows(candidates, n_gram_length)
        best = self._select_per_cluster(scored, clusters, minimum_score)
        return best.values()

    # -- stages ---------------------------------------------------------

    @staticmethod
    def _drop_cross_cluster_constants(candidates_by_size: dict):
        """A range holding the same value in several clusters cannot encode
        the length; remove it everywhere."""
        seen = Counter(
            (rng.start, rng.length, rng.value.tobytes())
            for ranges in candidates_by_size.values() for rng in ranges)
        for size, ranges in candidates_by_size.items():
            candidates_by_size[size] = [
                rng for rng in ranges
                if seen[(rng.start, rng.length, rng.value.tobytes())] < 2]

    @staticmethod
    def _score_all_windows(candidates_by_size: dict, n_gram_length: int) -> dict:
        """scored[cluster_size][window_bits] = list of best-per-candidate
        CommonRanges; every aligned start inside each candidate is tried."""
        if n_gram_length == 8:
            window_sizes = (8, 16, 32, 64)
            byteorders = ("big", "little")
        else:
            window_sizes = tuple(n_gram_length * k for k in range(1, 5))
            byteorders = ("big",)

        scored = {size: {w: [] for w in window_sizes}
                  for size in candidates_by_size}

        for size, ranges in candidates_by_size.items():
            for w in window_sizes:
                for rng in ranges:
                    if rng.length < w:
                        continue
                    best = None
                    for start in range(0, rng.length + 1 - w, n_gram_length):
                        for bo in byteorders:
                            s = _score_window(rng.value[start : start + w],
                                              size, start, bo)
                            if best is None or s > best[0]:
                                best = (s, start, bo)
                    s, start, bo = best
                    scored[size][w].append(CommonRange(
                        rng.start + start, w, rng.value[start : start + w],
                        score=s, field_type="length",
                        message_indices=rng.message_indices,
                        range_type=rng.range_type, byte_order=bo))
        return scored

    def _select_per_cluster(self, scored: dict, clusters: dict,
                            minimum_score: float) -> dict:
        # keep only the top-scoring candidate per (cluster, window size),
        # then commit to the window size that scores in the most clusters
        winners = defaultdict(dict)
        votes = Counter()
        for size, by_window in scored.items():
            for w, ranges in by_window.items():
                good = [r for r in ranges if r.score >= minimum_score]
                if good:
                    winners[size][w] = max(good, key=lambda r: r.score)
                    votes[w] += 1

        if not votes:
            return {}
        chosen_w = max(votes, key=lambda w: (votes[w], w))

        best = {size: by_w[chosen_w] for size, by_w in winners.items()
                if chosen_w in by_w}

        # singleton clusters have no within-cluster agreement; reuse the
        # best-matching window found elsewhere
        for size, indices in clusters.items():
            if len(indices) != 1:
                continue
            bv = self.bitvectors[indices[0]]
            adopted, top = None, 0.0
            for rng in best.values():
                bits = bv[rng.start : rng.end + 1]
                if len(bits) == 0:
                    continue
                s = _score_window(bits, size, rng.start)
                if s > top:
                    adopted, top = rng, s
            if adopted is not None:
                best[size] = CommonRange(
                    adopted.start, adopted.length,
                    value=bv[adopted.start : adopted.end + 1],
                    score=top, field_type="length",
                    message_indices={indices[0]}, range_type="bit")
        return best

    # kept for API parity with tests / external callers
    score_bits = staticmethod(_score_window)
