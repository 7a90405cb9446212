"""Column-agreement histogram over message vectors.

Behavioral contract: urh/awre/Histogram.py, but the per-pair column
comparison is the device-batched value-count kernel
(urh_tpu_torch.awre.device.column_agreement) and run extraction is one
np.diff pass instead of an index walk.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.awre.common_range import CommonRange


class Histogram:
    def __init__(self, vectors, indices=None, normalize=True, debug=False, device=None):
        self._vectors = vectors
        self._active_indices = (list(range(len(vectors))) if indices is None
                                else indices)
        self.normalize = normalize
        self.data = awre_kernels.create_difference_histogram(vectors,
                                                             self._active_indices, device)

    def find_common_ranges(self, alpha=0.95, range_type="bit") -> list:
        """Maximal runs (>= 2 columns) where at least alpha of vector pairs
        agree, as CommonRanges valued from the first active vector."""
        agreeing = np.flatnonzero(self.data >= alpha)
        if len(agreeing) < 2:
            return []

        # split the agreeing column indices into maximal consecutive runs
        gap_after = np.flatnonzero(np.diff(agreeing) > 1)
        run_bounds = zip(np.r_[0, gap_after + 1], np.r_[gap_after, len(agreeing) - 1])

        first = np.asarray(self._vectors[self._active_indices[0]])
        result = []
        for lo, hi in run_bounds:
            n_cols = int(agreeing[hi] - agreeing[lo] + 1)
            if n_cols < 2:
                continue
            col = int(agreeing[lo])
            result.append(CommonRange(col, n_cols, first[col : col + n_cols],
                                      message_indices=set(self._active_indices),
                                      range_type=range_type))
        return result

    def __repr__(self):
        return str(self.data.tolist())
