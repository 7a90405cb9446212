"""The receive ring between the SDR and the sniffer, as URH runs it (C5).

The sink writes each batch of frames at its write index, and restarts at 0
when a batch would reach the end of the buffer; it tells nobody.  The
drain then reads from its position to the end of the buffer, then from 0:
the tail of the buffer that this lap did not write is stale, either an
older lap's samples or the buffer's initial zeros, and it is fed to the
stream between the lap's last batch and the next lap's first.  Given the
sizes of the batches in the order they came, :func:`fed_pieces` says which
samples the stream was fed.
"""

from __future__ import annotations


def fed_pieces(batch_lengths, size: int) -> list:
    """-> [(sent offset or None for zeros, length)] of the fed stream, in
    order, for batches of the given lengths through a ring of ``size``
    samples."""
    pieces, laps = [], []  # laps: (sent offset at ring index 0, samples written)
    sent, lap_start, index = 0, 0, 0
    for n in batch_lengths:
        if n <= 0:
            continue
        if index + n >= size:
            pieces.append((lap_start, index))
            laps.append((lap_start, index))
            pieces.extend(stale(laps, index, size))
            lap_start, index = sent, 0
        index += n
        sent += n
    pieces.append((lap_start, index))
    return [(o, n) for o, n in pieces if n > 0]


def stale(laps: list, lo: int, size: int) -> list:
    """The ring's contents over [lo, size) at the end of the newest lap: at
    each index the newest earlier lap that wrote it, else zeros."""
    out, r = [], lo
    older = laps[:-1]
    while r < size:
        owner = next(((o, w) for o, w in reversed(older) if w > r), None)
        if owner is None:
            out.append((None, size - r))
            break
        o, w = owner
        # every newer lap ended at or before r, so the owner holds r to its end
        out.append((o + r, w - r))
        r = w
    return out


def sent_position(pieces: list, fed: int) -> int:
    """The sent sample a fed position stands for: itself where fresh, the
    first sample after the splice where stale."""
    pos, after = 0, 0
    for offset, n in pieces:
        fresh = offset is not None and offset == after
        if fed < pos + n:
            return offset + (fed - pos) if fresh else after
        if fresh:
            after = offset + n
        pos += n
    return after


def _laps(batch_lengths, size: int) -> tuple:
    """-> (how many times the ring restarted at 0, its write index at the end)."""
    count = index = 0
    for n in batch_lengths:
        if n <= 0:
            continue
        if index + n >= size:
            count, index = count + 1, 0
        index += n
    return count, index


def wraps(batch_lengths, size: int) -> int:
    """How many times the ring restarted at 0."""
    return _laps(batch_lengths, size)[0]


def final_index(batch_lengths, size: int) -> int:
    """The ring's write index after the batches."""
    return _laps(batch_lengths, size)[1]
