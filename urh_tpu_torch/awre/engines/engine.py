"""awre engine base: shared candidate-range machinery.

Behavioral contract: urh/awre/engines/Engine.py.  The exhaustive
pairwise search runs all pairs through one device equality map
(urh_tpu_torch.awre.device.pairwise_equality) instead of per-pair histogram
objects.
"""

from __future__ import annotations

import itertools

import numpy as np

from urh_tpu_torch.awre import device as awre_device
from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.awre.common_range import CommonRange
from urh_tpu_torch.awre.histogram import Histogram


class Engine:
    _DEBUG_ = False

    def _debug(self, *args):
        if self._DEBUG_:
            print("[{}]".format(self.__class__.__name__), *args)

    @staticmethod
    def find_common_ranges_by_cluster(msg_vectors, clustered_bitvectors,
                                      alpha=0.95, range_type="bit", device=None) -> dict:
        """Per-cluster histogram ranges at the given participation level."""
        return {
            cluster: Histogram(msg_vectors, indices, device=device).find_common_ranges(
                alpha=alpha, range_type=range_type)
            for cluster, indices in clustered_bitvectors.items()
        }

    @staticmethod
    def find_common_ranges_exhaustive(msg_vectors, msg_indices,
                                      range_type="bit") -> list:
        """All-pairs (alpha=1) common ranges, merged by (start, value).

        One batched equality map covers every pair; runs of agreeing
        columns per pair become ranges, keyed and merged on host.
        """
        pairs = np.array(list(itertools.combinations(msg_indices, 2)), dtype=np.int64)
        if len(pairs) == 0:
            return []
        data, lengths = awre_device.pack_messages(msg_vectors)
        eq_map = awre_device.pairwise_equality(data, lengths, pairs)

        merged = {}
        order = []
        for (i, j), eq_row in zip(pairs, eq_map):
            agreeing = np.flatnonzero(eq_row)
            if len(agreeing) < 2:
                continue
            gap_after = np.flatnonzero(np.diff(agreeing) > 1)
            vec_i = np.asarray(msg_vectors[i])
            for lo, hi in zip(np.r_[0, gap_after + 1],
                              np.r_[gap_after, len(agreeing) - 1]):
                n_cols = int(agreeing[hi] - agreeing[lo] + 1)
                if n_cols < 2:
                    continue
                col = int(agreeing[lo])
                value = vec_i[col : col + n_cols]
                key = (col, value.tobytes())
                if key in merged:
                    merged[key].message_indices.update({int(i), int(j)})
                else:
                    merged[key] = CommonRange(col, n_cols, value,
                                              message_indices={int(i), int(j)},
                                              range_type=range_type)
                    order.append(key)
        return [merged[k] for k in order]

    @staticmethod
    def ignore_already_labeled(common_ranges, already_labeled) -> list:
        """Trim/split ranges so none overlaps an already-labeled span."""
        surviving = []
        for rng in common_ranges:
            pieces = [rng]
            for span in already_labeled:
                pieces = [p for piece in pieces
                          for p in piece.ensure_not_overlaps(*span)]
            surviving.extend(pieces)
        return surviving

    @staticmethod
    def find_longest_common_sub_sequences(seq1, seq2) -> list:
        if seq1 is None or seq2 is None:
            return []
        spans = awre_kernels.find_longest_common_sub_sequence_indices(seq1, seq2)
        return [seq1[lo:hi] for lo, hi in spans if hi > lo]
