"""CSV signal import: oscilloscope/logic-analyzer CSV exports -> IQ (host
copy of urh_tpu.util.csv_import).

Counterpart of the parsing core of
urh/controller/dialogs/CSVImportDialog.py:125-190 (GUI preview replaced by
the library API), rebuilt as a vectorized table load: the whole file goes
through one `np.genfromtxt` pass with the selected columns, malformed or
header rows surface as NaNs and are dropped with a single mask, and the
sample rate comes from the mean timestamp delta over the preview window.
"""

from __future__ import annotations

import warnings

import numpy as np

PREVIEW_ROWS = 100


def _load_columns(filename: str, separator: str,
                  columns: list[int]) -> np.ndarray:
    """(rows, len(columns)) float array; unparsable cells become NaN."""
    with open(filename, encoding="utf-8-sig") as f, warnings.catch_warnings():
        # rows with too few columns (headers, comments) are dropped via NaN
        warnings.simplefilter("ignore")
        table = np.genfromtxt(f, delimiter=separator, usecols=columns,
                              dtype=np.float64, invalid_raise=False)
    if table.size == 0:
        return np.zeros((0, len(columns)))
    return table.reshape(-1, len(columns))


def estimate_sample_rate(timestamps) -> float | None:
    """1 / mean(|Δt|) over the first PREVIEW_ROWS timestamps
    (semantics of CSVImportDialog.py:177-190)."""
    t = np.asarray(timestamps, dtype=np.float64)[:PREVIEW_ROWS]
    if t.size < 2:
        return None
    mean_delta = np.abs(np.diff(t)).mean()
    return None if mean_delta == 0 else float(1.0 / mean_delta)


def parse_csv_file(filename: str, separator: str, i_data_col: int,
                   q_data_col: int = -1, t_data_col: int = -1):
    """-> (complex64 samples normalized to peak 1.0, estimated sample rate
    or None) (semantics of CSVImportDialog.py:155-175)."""
    wanted = [c for c in (i_data_col, q_data_col, t_data_col) if c >= 0]
    if not wanted:
        return np.zeros(0, dtype=np.complex64), None
    table = _load_columns(filename, separator, wanted)

    # a row is valid iff every requested column parsed
    valid = ~np.isnan(table).any(axis=1)
    table = table[valid]

    slot = {col: i for i, col in enumerate(wanted)}
    i_part = table[:, slot[i_data_col]] if i_data_col >= 0 else 0.0
    q_part = table[:, slot[q_data_col]] if q_data_col >= 0 else 0.0
    iq_data = (i_part + 1j * q_part).astype(np.complex64)

    sample_rate = (estimate_sample_rate(table[:, slot[t_data_col]])
                   if t_data_col >= 0 else None)
    # reference parity (CSVImportDialog.py:175): the divisor is
    # abs(max(iq_data)) — numpy's lexicographic complex max, i.e. the
    # magnitude of the sample with the largest REAL part — not the true
    # peak magnitude
    peak = np.abs(iq_data.max()) if iq_data.size else 0.0
    if peak > 0:
        iq_data = iq_data / peak
    return iq_data, sample_rate


def csv_to_signal(filename: str, separator: str = ",", i_data_col: int = 1,
                  q_data_col: int = -1, t_data_col: int = -1, device=None):
    """Convenience: parse a CSV capture straight into a Signal on
    ``device`` (default: the CUDA card)."""
    from urh_tpu_torch.core.signal import Signal

    data, sample_rate = parse_csv_file(filename, separator, i_data_col,
                                       q_data_col, t_data_col)
    return Signal.from_samples(data, filename, sample_rate or 1e6, device=device)
