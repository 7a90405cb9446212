"""awre primitive kernels: host API over the batched device kernels.

The heavy integer primitives (pairwise difference matrix, column
agreement histogram, n-gram/sequence-number matrices, occurrence
search, batched CRC) live in :mod:`urh_tpu_torch.awre.device` as torch
programs over padded message tensors on the caller's ``device``; this
module packs ragged Python-side message lists, hands them on, and hosts
the small vectorized helpers (preamble structure, sync-word voting, LCS)
that stay CPU-side.

Behavioral contract: urh/cythonext/awre_util.pyx (369 LoC of Cython
loops) — same outputs, batched dataflow.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from urh_tpu_torch.awre import device as awre_device


def bit_array_to_number(bits, end: int, start: int = 0) -> int:
    """MSB-first value of bits[start:end] (util.pyx:50-61).

    One packbits pass + int.from_bytes — C-speed for any width."""
    if end < 1 or end <= start:
        return 0
    if end - start > 24:
        # wide windows: one packbits pass beats the per-bit fold
        arr = np.asarray(bits[start:end], dtype=np.uint8)
        if arr.max(initial=0) <= 1:
            pad = (-arr.size) % 8
            if pad:
                arr = np.concatenate((np.zeros(pad, np.uint8), arr))
            return int.from_bytes(np.packbits(arr).tobytes(), "big")
    value = 0
    for i in range(start, end):
        value = (value << 1) | int(bits[i])
    return value


def find_longest_common_sub_sequence_indices(seq1: np.ndarray, seq2: np.ndarray) -> set:
    """Up to 10 (start, end) positions in seq1 of the longest common
    substring of seq1/seq2 (awre_util.pyx:15-44)."""
    seq1 = np.asarray(seq1, dtype=np.uint8)
    seq2 = np.asarray(seq2, dtype=np.uint8)
    n1, n2 = len(seq1), len(seq2)
    if n1 == 0 or n2 == 0:
        return {(0, 0)}

    # DP counter matrix of common-suffix lengths, one vectorized row step
    c = np.zeros((n1 + 1, n2 + 1), dtype=np.uint32)
    eq = seq1[:, None] == seq2[None, :]
    for i in range(n1):
        c[i + 1, 1:] = np.where(eq[i], c[i, :-1] + 1, 0)

    longest = int(c.max())
    if longest == 0:
        return {(0, 0)}
    pos = np.argwhere(c == longest)  # row-major order, like the scan
    result = set()
    for i_plus1, _ in pos[:10]:
        i = int(i_plus1) - 1
        result.add((i - longest + 1, i + 1))
    return result


def find_first_difference(bits1, bits2) -> int:
    a = np.asarray(bits1, dtype=np.uint8)
    b = np.asarray(bits2, dtype=np.uint8)
    smaller = min(len(a), len(b))
    neq = a[:smaller] != b[:smaller]
    idx = np.flatnonzero(neq)
    return int(idx[0]) if len(idx) else smaller


def get_difference_matrix(bitvectors: list, device=None) -> np.ndarray:
    """(N, N) matrix of pairwise first-difference positions (upper
    triangle meaningful), batched on device (awre_util.pyx:46-68)."""
    n = len(bitvectors)
    if n < 2:
        return np.zeros((n, n), dtype=np.uint32)
    data, lengths = awre_device.pack_messages(bitvectors)
    full = awre_device.first_difference_matrix(data, lengths, device)
    return np.triu(full, k=1).astype(np.uint32)


def get_hexvectors(bitvectors: list, device=None) -> list:
    """Bit arrays -> nibble arrays via the 4-gram matmul; partial
    trailing nibbles keep their MSB-first value (awre_util.pyx:70-90)."""
    if not bitvectors:
        return []
    data, lengths = awre_device.pack_messages(bitvectors)
    values, _ = awre_device.ngram_values(data, lengths, 4, device)
    return [values[i, : math.ceil(int(lengths[i]) / 4)].astype(np.uint8)
            for i in range(len(bitvectors))]


def _lower_multiple_of_n(number: int, n: int) -> int:
    return n * (number // n)


def get_raw_preamble_position(bitvector: np.ndarray) -> tuple:
    """(message_start, preamble_lower, preamble_upper) of an a^n b^m
    repetition at the message head (awre_util.pyx:103-167).

    The per-window scan of the reference is replaced by one reshape +
    row-compare per candidate start (the outer start loop advances at
    most a couple of times on real signals).
    """
    bits = np.asarray(bitvector, dtype=np.uint8)
    total = len(bits)
    if total == 0:
        return 0, 0, 0

    start = -1
    reps = 0.0
    lower = upper = 0
    while reps < 2 and start < total - 1:
        start += 1
        a = bits[start]
        b = 1 - a
        tail = bits[start:]

        b_hits = np.flatnonzero(tail == b)
        if len(b_hits) == 0 or b_hits[0] <= 0:
            return 0, 0, 0
        n = int(b_hits[0])
        a_hits = np.flatnonzero(tail[n:] == a)
        if len(a_hits) == 0 or a_hits[0] <= 0:
            return 0, 0, 0
        m = int(a_hits[0])

        plen = n + m
        pattern = np.concatenate([np.full(n, a, np.uint8), np.full(m, b, np.uint8)])

        # all full windows at stride plen, compared in one shot
        full_windows = len(tail) // plen
        if full_windows:
            grid = tail[: full_windows * plen].reshape(full_windows, plen)
            ok = (grid == pattern[None, :]).all(axis=1)
            run = int(np.argmin(ok)) if not ok.all() else full_windows
        else:
            run = 0

        if run < full_windows:
            preamble_end = start + run * plen
        elif len(tail) % plen != 0:
            # trailing short window breaks the repetition
            preamble_end = start + full_windows * plen
        else:
            # scan ran off the end without a break (reference for-else)
            preamble_end = start

        upper = start + _lower_multiple_of_n(preamble_end + 1 - start, plen)
        lower = upper - plen
        reps = (upper - start) / plen

    if reps > 2:
        return start, lower, upper
    return 0, 0, 0


def find_possible_sync_words(difference_matrix: np.ndarray,
                             raw_preamble_positions: np.ndarray,
                             bitvectors: list, n_gram_length: int) -> dict:
    """Score candidate sync words between preamble end and first pairwise
    difference (awre_util.pyx:170-231).

    Vectorized restructure: all (pair, endpoint, preamble-bound) start /
    length combinations are computed as flat arrays; the per-candidate
    dict accumulation collapses to a unique() over (message, start, len)
    triples.
    """
    scores: dict = {}
    rows, cols = np.nonzero(np.triu(difference_matrix, k=1))
    if len(rows) == 0:
        return scores
    sync_ends = difference_matrix[rows, cols].astype(np.int64)

    pre = np.asarray(raw_preamble_positions, dtype=np.int64)
    msg_idx_parts = []
    start_parts = []
    end_parts = []
    for endpoint in (rows, cols):
        for bound in (1, 2):  # lower / upper preamble length column
            starts = pre[endpoint, 0] + pre[endpoint, bound]
            lens = sync_ends - starts
            lens = (lens // n_gram_length) * n_gram_length
            lens = np.maximum(lens, 0)
            msg_idx_parts.append(endpoint)
            start_parts.append(starts)
            end_parts.append(lens)

    msg_idx = np.concatenate(msg_idx_parts)
    starts = np.concatenate(start_parts)
    lens = np.concatenate(end_parts)

    keep = lens >= 2
    msg_idx, starts, lens = msg_idx[keep], starts[keep], lens[keep]
    if len(msg_idx) == 0:
        return scores

    # half weight when the sync does not end on an n-gram boundary
    weights = np.where((starts + lens) % n_gram_length == 0, 1.0, 0.5)

    # fold each (message, start, len) triple into one int64 key — a 1-D
    # unique is an order of magnitude cheaper than unique(axis=0)'s
    # row-sort over millions of rows.  The packed layout holds only for
    # starts/lens < 2^20 and msg_idx < 2^23 (bitvectors up to ~1M bits);
    # beyond that fall back to the row-wise unique, which has no limit.
    if (len(bitvectors) < (1 << 23) and starts.max() < (1 << 20)
            and lens.max() < (1 << 20)):
        keys = (msg_idx << 40) | (starts << 20) | lens
        uniq_keys, inverse = np.unique(keys, return_inverse=True)
        uniq = np.stack([uniq_keys >> 40, (uniq_keys >> 20) & 0xFFFFF,
                         uniq_keys & 0xFFFFF], axis=1)
    else:
        rows = np.stack([msg_idx, starts, lens], axis=1)
        uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    weight_sums = np.bincount(inverse.reshape(-1), weights=weights,
                              minlength=len(uniq))

    for (mi, st, ln), w in zip(uniq, weight_sums):
        bv = np.asarray(bitvectors[mi], dtype=np.uint8)
        word = bv[st : st + ln]
        if ln == 2 and word[0] != word[1]:
            # "10"/"01" would be indistinguishable from preamble
            continue
        key = word.tobytes()
        scores[key] = scores.get(key, 0) + w
    return scores


def create_difference_histogram(vectors: list, active_indices, device=None) -> np.ndarray:
    """histogram[k] = fraction of pairs of active vectors agreeing at
    column k; pairs involving a too-short vector count as unequal
    (awre_util.pyx:233-263).  Device-batched column counting."""
    active_indices = list(active_indices)
    if len(active_indices) < 2:
        lens = [len(vectors[i]) for i in active_indices]
        return np.zeros(max(lens) if lens else 0, dtype=np.float64)
    subset = [vectors[i] for i in active_indices]
    data, lengths = awre_device.pack_messages(subset)
    alphabet = 16 if data[data != 255].max(initial=0) < 16 else 255
    return awre_device.column_agreement(data, lengths, alphabet_size=alphabet, device=device)


def find_occurrences(a, b, ignore_indices=None, return_after_first=False) -> list:
    """Start indices of exact occurrences of b in a, skipping windows that
    touch ignore_indices (awre_util.pyx:265-301)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    len_a, len_b = len(a), len(b)
    if len_b > len_a or len_b == 0:
        return []

    windows = np.lib.stride_tricks.sliding_window_view(a, len_b)
    matches = (windows == b).all(axis=1)

    if ignore_indices:
        ignore = np.zeros(len_a, dtype=bool)
        for idx in ignore_indices:
            if 0 <= idx < len_a:
                ignore[idx] = True
        touched = np.lib.stride_tricks.sliding_window_view(ignore, len_b).any(axis=1)
        matches = matches & ~touched

    hits = np.flatnonzero(matches)
    if return_after_first:
        return [int(hits[0])] if len(hits) else []
    return [int(h) for h in hits]


def batch_find_occurrences(vectors: list, patterns: list, ignore_columns=(),
                           device=None) -> dict:
    """All occurrences of all patterns in all vectors at once.

    Returns {(vector_index, pattern_index): [starts...]} for non-empty
    hit lists; one device program replaces the O(N*K) host scans."""
    if not vectors or not patterns:
        return {}
    data, lengths = awre_device.pack_messages(vectors)
    result = {}
    for (row_lo, pat_lo), hits in awre_device.iter_occurrence_chunks(
            data, lengths, patterns, ignore_columns, device=device):
        vi, pi, si = np.nonzero(hits)
        for v, p, s in zip(vi, pi, si):
            result.setdefault((int(v) + row_lo, int(p) + pat_lo), []).append(int(s))
    return result


def create_seq_number_difference_matrix(bitvectors: list, n_gram_length: int,
                                        device=None) -> np.ndarray:
    """(N-1, M) matrix of consecutive-message n-gram deltas mod 2^n,
    device-batched (awre_util.pyx:303-369)."""
    data, lengths = awre_device.pack_messages(bitvectors)
    return awre_device.seqnum_delta_matrix(data, lengths, n_gram_length, device)


def pack_indices_by_length(bitvectors, message_indices) -> dict:
    """{bit_length: (index_array, (B, L) uint8 matrix)} — pack a message
    cluster once so repeated CRC verifications slice matrices instead of
    re-converting every bitvector per hypothesis."""
    by_len = defaultdict(list)
    for index in message_indices:
        by_len[len(bitvectors[index])].append(index)
    return {
        L: (np.asarray(idxs, dtype=np.int64),
            np.stack([np.asarray(bitvectors[i], dtype=np.uint8)
                      for i in idxs]) if idxs else np.zeros((0, L), np.uint8))
        for L, idxs in by_len.items()
    }


def check_crc_for_messages_packed(packed: dict, data_start, data_stop,
                                  crc_start, crc_stop, crc_polynomial,
                                  crc_start_value, crc_final_xor,
                                  crc_lsb_first, crc_reverse_polynomial,
                                  crc_reverse_all, crc_little_endian, device=None) -> set:
    """check_crc_for_messages over a pack_indices_by_length result."""
    width = crc_stop - crc_start
    weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
    result = set()
    for L, (idxs, mat) in packed.items():
        if L < crc_stop or len(idxs) == 0:
            continue
        payload = mat[:, data_start:min(data_stop, L)]
        if payload.shape[1] <= 0:
            continue
        stored = mat[:, crc_start:crc_stop].astype(np.int64) @ weights
        computed = np.asarray(awre_device.batched_crc(
            payload, crc_polynomial, crc_start_value, crc_final_xor,
            crc_lsb_first, crc_reverse_polynomial, crc_reverse_all,
            crc_little_endian, device), dtype=np.int64)
        result.update(int(i) for i in idxs[stored == computed])
    return result


def check_crc_for_messages(message_indices, bitvectors, data_start, data_stop,
                           crc_start, crc_stop, crc_polynomial, crc_start_value,
                           crc_final_xor, crc_lsb_first, crc_reverse_polynomial,
                           crc_reverse_all, crc_little_endian, device=None) -> set:
    """Indices of messages whose stored CRC matches the computed one.

    Messages are grouped by payload length and each group's CRCs come
    from one GF(2) matmul (device.batched_crc) instead of per-message
    bitwise loops."""
    width = crc_stop - crc_start
    groups = defaultdict(list)
    for index in message_indices:
        bits = np.asarray(bitvectors[index], dtype=np.uint8)
        if len(bits) < crc_stop:
            continue
        groups[min(data_stop, len(bits)) - data_start].append((index, bits))

    weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
    result = set()
    for payload_len, entries in groups.items():
        if payload_len <= 0:
            continue
        stacked = np.stack([bits[data_start:data_start + payload_len]
                            for _, bits in entries])
        stored_mat = np.stack([bits[crc_start:crc_stop]
                               for _, bits in entries])
        stored_ints = stored_mat.astype(np.int64) @ weights
        computed = awre_device.batched_crc(
            stacked, crc_polynomial, crc_start_value, crc_final_xor,
            crc_lsb_first, crc_reverse_polynomial, crc_reverse_all,
            crc_little_endian, device)
        computed = np.asarray(computed, dtype=np.int64)
        for (index, _), ok in zip(entries, stored_ints == computed):
            if ok:
                result.add(index)
    return result
