"""Sequence-number inference.

Behavioral contract: urh/awre/engines/SequenceNumberEngine.py — a
counter shows up as an n-gram column whose consecutive-message deltas
are dominated by one nonzero constant; adjacent columns merge into
multi-byte counters (the varying byte sits right of constant-delta
bytes for big endian, left for little endian).

The delta matrix comes from one device n-gram matmul
(urh_tpu_torch.awre.device.seqnum_delta_matrix); per-column frequency
statistics are one bincount sweep.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.awre.common_range import CommonRange
from urh_tpu_torch.awre.engines.engine import Engine


def _column_stats(deltas: np.ndarray) -> list:
    """Per column: dict {delta_value: count} over the (N-1) row deltas."""
    stats = []
    for col in range(deltas.shape[1]):
        values, counts = np.unique(deltas[:, col], return_counts=True)
        stats.append(dict(zip(values.tolist(), counts.tolist())))
    return stats


def _dominant_step(freq: dict) -> int:
    """Most frequent delta that is neither 0 nor the -1 padding marker."""
    real = {d: c for d, c in freq.items() if d not in (0, -1)}
    if not real:
        raise ValueError("no nonzero delta")
    return max(real, key=real.get)


def _purity(freq: dict) -> float:
    """Fraction of nonzero deltas taken by the dominant step."""
    total = sum(freq.values())
    zeros = freq.get(0, 0)
    if zeros == total:
        return 0.0
    try:
        step = _dominant_step(freq)
    except ValueError:
        return 0.0
    return freq[step] / (total - zeros)


class SequenceNumberEngine(Engine):
    def __init__(self, bitvectors, n_gram_length=8, minimum_score=0.75,
                 already_labeled: list = None, device=None):
        self.bitvectors = bitvectors
        self.device = device
        self.n_gram_length = n_gram_length
        self.minimum_score = minimum_score
        spans = already_labeled or []
        self.already_labeled_cols = {pos // n_gram_length
                                     for lo, hi in spans for pos in range(lo, hi)}

    def find(self):
        n = self.n_gram_length
        if len(self.bitvectors) < 3:
            # fewer than 3 messages cannot establish a counting pattern
            return []

        deltas = self.create_difference_matrix(self.bitvectors, n, self.device)
        stats = _column_stats(deltas)
        scores = [0.0 if col in self.already_labeled_cols else _purity(freq)
                  for col, freq in enumerate(stats)]

        counters = []
        for col in sorted(range(len(scores)), key=scores.__getitem__, reverse=True):
            if scores[col] < self.minimum_score:
                continue
            step = _dominant_step(stats[col])
            hit_rows = np.flatnonzero((deltas[:, col] == step) | (deltas[:, col] == 0))
            # delta row r couples messages r and r+1
            members = set(hit_rows.tolist()) | set((hit_rows + 1).tolist())
            values = {np.asarray(self.bitvectors[i])[col * n : (col + 1) * n].tobytes()
                      for i in members}

            peers = [c for c in counters if c.message_indices == members]
            if not self._absorb_adjacent(peers, col, values, n):
                fresh = CommonRange(start=col * n, length=n, score=scores[col],
                                    field_type="sequence number",
                                    message_indices=members, byte_order=None)
                fresh.values.extend(values)
                counters.append(fresh)

        # a believable counter shows at least 3 distinct values
        return [c for c in counters if len(set(c.values)) > 2]

    @staticmethod
    def _absorb_adjacent(peers: list, col: int, values: set, n: int) -> bool:
        """Attach column `col` to an adjacent existing counter: big endian
        grows rightward, little endian leftward."""
        for c in peers:
            if c.start == (col - 1) * n and (c.byte_order_is_unknown
                                             or c.byte_order == "big"):
                c.length += n
                c.byte_order = "big"
                c.values.extend(values)
                return True
        for c in peers:
            if c.start == (col + 1) * n and (c.byte_order_is_unknown
                                             or c.byte_order == "little"):
                c.start -= n
                c.length += n
                c.byte_order = "little"
                c.values.extend(values)
                return True
        return False

    # API parity with the reference engine
    @staticmethod
    def get_most_frequent(diff_frequencies: dict):
        return _dominant_step(diff_frequencies)

    @staticmethod
    def calc_score(diff_frequencies: dict) -> float:
        return _purity(diff_frequencies)

    @staticmethod
    def create_difference_matrix(bitvectors, n_gram_length: int, device=None) -> np.ndarray:
        return awre_kernels.create_seq_number_difference_matrix(bitvectors,
                                                                n_gram_length, device)
