"""Batched device programs for protocol reverse engineering (awre).

PyTorch port of urh_tpu.awre.device, the integer primitives behind awre
(reference: urh/cythonext/awre_util.pyx, per-element Cython loops).  Every
primitive operates on the *whole message set at once* as a padded uint8
tensor on an explicit ``device`` (the caller's; there is no module-wide
device).  Each call runs on the device it is given; under ``"auto"`` it
is placed as urh_tpu places it: the CPU below DEVICE_MIN_CELLS cells
(scaled by the measured dispatch cost), else a race of the card and the
CPU under urh_tpu's key (:func:`urh_tpu_torch.util.placement.run`):

* messages are packed once on the host into ``(N, L)`` uint8 + ``(N,)``
  lengths (:func:`pack_messages`), L bucketed to powers of two;
* pairwise first-difference positions (awre_util.pyx:46-68) become one
  broadcast-compare + argmax over ``(B, N, L)`` row blocks;
* the column-agreement histogram (awre_util.pyx:233-263) uses the
  value-count identity  #equal-pairs(col) = sum_v C(count_v(col), 2);
* n-gram extraction (awre_util.pyx:303-369) is a reshape and a weighted
  sum in int64, exact for every n;
* pattern occurrence is a one-hot cross-correlation (``conv1d`` over 16
  channels), exact in float32 (counts of at most the pattern length);
* generic CRCs over equal-length messages exploit GF(2) linearity:
  crc(m) = (m @ G) mod 2 xor crc(0) with a per-(config, length)
  generator matrix, one (N, L) x (L, W) float32 matmul of 0/1 values,
  exact while L < 2^24 (:func:`batched_crc`).

Every result equals urh_tpu's, integer for integer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.util import placement

# below this many cells a call goes to the CPU under device="auto"
DEVICE_MIN_CELLS = 1 << 16

_PAD = 255  # uint8 padding sentinel; real alphabets are bits (0/1) or nibbles
_ALPHABET = 16  # uint8 symbol values of the occurrence search: bits or nibbles
_F32_EXACT = 1 << 24  # float32 holds every integer below this exactly


def _bucket(n: int) -> int:
    """Round up to a power of two (>= 8)."""
    b = 8
    while b < n:
        b <<= 1
    return b


def _to(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(resolve_device(device))


def use_device(n_cells: int) -> bool:
    """urh_tpu's size rule for a placed call (needs the card's probe)."""
    return n_cells >= placement.scaled_threshold(DEVICE_MIN_CELLS)


def pack_messages(vectors) -> tuple:
    """Pack ragged uint8 vectors into (data (N, L), lengths (N,)).

    L is the padded (bucketed) width; columns >= lengths[i] hold _PAD.
    """
    n = len(vectors)
    lengths = np.fromiter((len(v) for v in vectors), dtype=np.int32, count=n)
    width = _bucket(int(lengths.max()) if n else 1)
    data = np.full((n, width), _PAD, dtype=np.uint8)
    for i, v in enumerate(vectors):
        data[i, : lengths[i]] = np.asarray(v, dtype=np.uint8)
    return data, lengths


# ---------------------------------------------------------------------------
# pairwise first-difference matrix
# ---------------------------------------------------------------------------


def _first_diff_block(block, block_lens, data, lengths):
    neq = block[:, None, :] != data[None, :, :]
    has_diff = neq.any(dim=2)
    # argmax takes no bool on CUDA; on uint8 it returns the first maximum
    first = neq.to(torch.uint8).argmax(dim=2).to(torch.int32)
    min_len = torch.minimum(block_lens[:, None], lengths[None, :])
    return torch.where(has_diff, torch.minimum(first, min_len), min_len)


def first_difference_matrix(data: np.ndarray, lengths: np.ndarray, device=None) -> np.ndarray:
    """(N, N) position of the first differing element of each row pair.

    Padding (_PAD) differs from every in-alphabet value, so rows of
    unequal length differ at min(len_i, len_j) at the latest; the result
    is clamped there, matching awre_util.pyx:46-68 exactly.
    """
    n, width = data.shape
    if n < 2:
        return np.zeros((n, n), dtype=np.int32)
    # bound block memory at ~64 Mi compare cells
    rows_per_block = max(1, (1 << 26) // max(1, n * width))

    def run(dev):
        out = np.zeros((n, n), dtype=np.int32)
        dev_data, dev_lens = _to(data, dev), _to(lengths, dev)
        for lo in range(0, n, rows_per_block):
            hi = min(n, lo + rows_per_block)
            out[lo:hi] = _first_diff_block(dev_data[lo:hi], dev_lens[lo:hi], dev_data,
                                           dev_lens).cpu().numpy()
        return out

    # an O(N^2) result: which side wins depends on the link, so it is raced
    return placement.run("awre.first_difference_matrix", lambda: use_device(n * n * width),
                         device, run)


# ---------------------------------------------------------------------------
# column agreement (difference histogram)
# ---------------------------------------------------------------------------


def _column_value_counts(data, lengths, alphabet_size):
    """(alphabet_size, L) int64: in-range cells of each value in each
    column, as one bincount over value * L + column."""
    width = data.shape[1]
    cols = torch.arange(width, device=data.device)
    values = data.to(torch.int64)
    keep = (cols[None, :] < lengths[:, None]) & (values < alphabet_size)
    slots = (values * width + cols[None, :])[keep]
    return torch.bincount(slots, minlength=alphabet_size * width).view(alphabet_size, width)


def column_agreement(data: np.ndarray, lengths: np.ndarray, alphabet_size: int = 16,
                     device=None) -> np.ndarray:
    """Fraction of row pairs agreeing at each column (length = max row len).

    Redesign of awre_util.pyx:233-263: instead of comparing all O(N^2)
    pairs per column, count per-column value occurrences and use
    #equal-pairs = sum_v C(c_v, 2).  Pairs where either row is too
    short count as disagreeing (the reference compares only up to
    min(len)).
    """
    n = data.shape[0]
    longest = int(lengths.max()) if n else 0
    if n < 2 or longest == 0:
        return np.zeros(longest, dtype=np.float64)
    counts = placement.run(
        "awre.column_value_counts", lambda: use_device(n * longest * alphabet_size), device,
        lambda dev: _column_value_counts(_to(data, dev), _to(lengths, dev),
                                         alphabet_size).cpu().numpy())
    counts = counts[:, :longest].astype(np.float64)
    equal_pairs = (counts * (counts - 1.0) / 2.0).sum(axis=0)
    return equal_pairs / (n * (n - 1) / 2)


# ---------------------------------------------------------------------------
# n-gram values & sequence-number deltas
# ---------------------------------------------------------------------------


def _ngram_matrix(data, lengths, n):
    width = data.shape[1]
    m = width // n
    cols = torch.arange(width, device=data.device)
    clean = torch.where(cols[None, :] < lengths[:, None], data, 0).to(torch.int64)
    # a weighted sum in int64 (CUDA has no integer matmul): exact for every n
    weights = torch.ones(n, dtype=torch.int64, device=data.device) << torch.arange(
        n - 1, -1, -1, device=data.device)
    vals = (clean[:, : m * n].reshape(data.shape[0], m, n) * weights).sum(-1)
    avail = torch.clamp(lengths[:, None].to(torch.int64)
                        - torch.arange(m, device=data.device)[None, :] * n, 0, n)
    return vals >> (n - avail), avail


def ngram_values(data: np.ndarray, lengths: np.ndarray, n: int, device=None) -> tuple:
    """MSB-first n-gram values of every row at stride n.

    Returns (values (N, M) int64, avail (N, M) bits available per gram).
    Partial tail grams use only the available bits (value >> missing),
    matching bit_array_to_number(bv, min(len, j+n), j).  Under ``"auto"``
    an n above 30 stays on the CPU, as urh_tpu keeps it on its host.
    """
    def run(dev):
        values, avail = _ngram_matrix(_to(data, dev), _to(lengths, dev), n)
        return values.cpu().numpy(), avail.cpu().numpy()

    return placement.run(f"awre.ngram_matrix:{n}", lambda: n <= 30 and use_device(data.size),
                         device, run)


def seqnum_delta_matrix(data: np.ndarray, lengths: np.ndarray, n: int,
                        device=None) -> np.ndarray:
    """(N-1, M) deltas of consecutive rows' n-gram values, mod 2^n.

    Grams beyond min(len_i, len_{i+1}) are -1 (awre_util.pyx:303-369).
    M spans ceil(max_len / n) columns.
    """
    num = data.shape[0]
    max_len = int(lengths.max()) if num else 0
    m_out = -(-max_len // n)
    values, _ = ngram_values(data, lengths, n, device)
    result = np.full((num - 1, values.shape[1]), -1, dtype=np.int32)
    delta = (values[1:] - values[:-1]) % (1 << n)
    k = np.minimum(lengths[1:], lengths[:-1])
    grams = -(-k // n)  # ceil
    cols = np.arange(values.shape[1])[None, :]
    result = np.where(cols < grams[:, None], delta.astype(np.int32), result)
    return result[:, :m_out]


# ---------------------------------------------------------------------------
# batched pattern occurrence search
# ---------------------------------------------------------------------------


def _occurrence(data, lengths, patterns, plens, ignore):
    """Pattern occurrence as a one-hot correlation.

    A window matches iff the number of (position, symbol)-coincidences
    equals the pattern length, so the whole (N, K, S) tensor is one
    ``conv1d`` (a cross-correlation, as urh_tpu's conv_general_dilated)
    over 16 one-hot channels.  The counts are at most the pattern length
    and the operands 0/1, so float32 (and cuDNN's TF32) holds them exactly.
    """
    ext_width = data.shape[1]
    pmax = patterns.shape[1]
    starts = ext_width - pmax
    sym = torch.arange(_ALPHABET, dtype=data.dtype, device=data.device)

    d1 = (data[:, None, :] == sym[None, :, None]).to(torch.float32)
    pat_pad = torch.arange(pmax, device=data.device)[None, :] >= plens[:, None]  # (K, P)
    q1 = ((patterns[:, None, :] == sym[None, :, None])
          & ~pat_pad[:, None, :]).to(torch.float32)
    # round(): cuDNN may pick an FFT or Winograd algorithm, whose sums of
    # 0/1 products come back within far less than 0.5 of the integer
    corr = F.conv1d(d1, q1)[..., :starts].round()  # (N, K, S)
    hit = corr == plens[None, :, None].to(corr.dtype)

    fits = (torch.arange(starts, device=data.device)[None, None, :] + plens[None, :, None]
            <= lengths[:, None, None])
    hit &= fits

    touched = ignore.to(torch.float32)[None, None, :]      # (1, 1, W)
    qa = (~pat_pad).to(torch.float32)[:, None, :]           # (K, 1, P)
    blocked = F.conv1d(touched, qa)[0][..., :starts].round() > 0
    return hit & ~blocked[None, :, :]


def _pack_patterns(patterns, width):
    k = len(patterns)
    plens = np.fromiter((len(p) for p in patterns), dtype=np.int32, count=k)
    pmax = min(_bucket(int(plens.max())), width)
    pat = np.zeros((k, pmax), dtype=np.uint8)
    for i, p in enumerate(patterns):
        pat[i, : plens[i]] = np.asarray(p, dtype=np.uint8)
    return pat, plens, pmax


def _ignore_vector(ignore_columns, width):
    ignore = np.zeros(width, dtype=bool)
    for c in ignore_columns:
        if 0 <= c < width:
            ignore[c] = True
    return ignore


def iter_occurrence_chunks(data: np.ndarray, lengths: np.ndarray, patterns,
                           ignore_columns=(), max_cells: int = 1 << 26, device=None):
    """Yield ((row_lo, pat_lo), hits) chunks of the (N, K, S) occurrence
    tensor, bounding the intermediate compare tensor at ~max_cells.

    Batched redesign of awre_util.pyx:265-301 — each chunk matches a
    block of (message, candidate) pairs in one device program.
    Windows touching ``ignore_columns`` never match.
    """
    n, width = data.shape
    k = len(patterns)
    if k == 0 or n == 0:
        return
    pat, plens, pmax = _pack_patterns(patterns, width)
    # extend with pmax pad columns: every start in [0, width) sees a
    # full (masked) window
    ext = np.full((n, width + pmax), _PAD, dtype=np.uint8)
    ext[:, :width] = data
    arrays = (ext, lengths, pat, plens, _ignore_vector(ignore_columns, width + pmax))
    on_device = {}  # each device's copy of the arrays, made at its first chunk
    starts = width

    k_chunk = max(1, min(k, max_cells // max(1, starts * pmax)))
    n_chunk = max(1, max_cells // max(1, k_chunk * starts * pmax))
    for row_lo in range(0, n, n_chunk):
        row_hi = min(n, row_lo + n_chunk)
        for pat_lo in range(0, k, k_chunk):
            pat_hi = min(k, pat_lo + k_chunk)

            def run(dev, row_lo=row_lo, row_hi=row_hi, pat_lo=pat_lo, pat_hi=pat_hi):
                if dev not in on_device:
                    on_device[dev] = [_to(a, dev) for a in arrays]
                ext_d, lens_d, pat_d, plens_d, ignore_d = on_device[dev]
                return _occurrence(ext_d[row_lo:row_hi], lens_d[row_lo:row_hi],
                                   pat_d[pat_lo:pat_hi], plens_d[pat_lo:pat_hi],
                                   ignore_d).cpu().numpy()

            # raced once a chunk shape, under urh_tpu's key
            key = (f"awre.occurrence:{_bucket(row_hi - row_lo)}x"
                   f"{pat_hi - pat_lo}x{starts}x{pmax}")
            yield (row_lo, pat_lo), placement.run(key, lambda: use_device(n * k * starts),
                                                  device, run)


def occurrence_matrix(data: np.ndarray, lengths: np.ndarray, patterns,
                      ignore_columns=(), device=None) -> np.ndarray:
    """(N, K, S) boolean: pattern k occurs in row n at start s.

    Materializes the full tensor — only for result sets known to be
    small; larger callers should consume iter_occurrence_chunks.
    """
    n, width = data.shape
    k = len(patterns)
    if k == 0 or n == 0:
        return np.zeros((n, k, 0), dtype=bool)
    out = np.zeros((n, k, width), dtype=bool)
    for (row_lo, pat_lo), hit in iter_occurrence_chunks(
            data, lengths, patterns, ignore_columns, device=device):
        out[row_lo : row_lo + hit.shape[0],
            pat_lo : pat_lo + hit.shape[1]] = hit
    return out


# ---------------------------------------------------------------------------
# pairwise equality map (exhaustive common-range search; host, as urh_tpu's)
# ---------------------------------------------------------------------------


def pairwise_equality(data: np.ndarray, lengths: np.ndarray,
                      pairs: np.ndarray) -> np.ndarray:
    """(P, L) boolean: rows pairs[p] agree at each column (both in range)."""
    left, right = pairs[:, 0], pairs[:, 1]
    eq = data[left] == data[right]
    cols = np.arange(data.shape[1])[None, :]
    in_range = cols < np.minimum(lengths[left], lengths[right])[:, None]
    return eq & in_range


# ---------------------------------------------------------------------------
# GF(2) batched CRC
# ---------------------------------------------------------------------------


# maxsize: the checksum engine probes MANY data-range lengths per run;
# 128 entries thrashed and recomputed generators mid-iteration
@functools.lru_cache(maxsize=4096)
def _crc_generator_matrix(params: tuple, length: int) -> tuple:
    """GF(2) generator for a CRC config over `length`-bit inputs.

    Returns (G (length, W) uint8, c0 (W,) uint8) with
    crc_bits(m) = (m @ G mod 2) xor c0 — every supported CRC option
    (reflect, lsb-first, final xor, little endian) is an affine GF(2)
    map, so this is exact.
    """
    from urh_tpu_torch.coding.crc import bits_to_int, crc_int

    (poly, start_value, final_xor, lsb_first, rev_poly, rev_all, le) = params
    width = len(poly) - 1

    if width <= 62:
        # all L+1 impulse CRCs in one batched column evolution (the rows
        # of the "message matrix" are the zero message + identity)
        from urh_tpu_torch.awre.crc_search import (_column_order, _evolve_states,
                                                   _finalize_vec)

        crc_mask = (1 << width) - 1
        poly_int = bits_to_int(list(poly), rev_poly, 1) & crc_mask
        start_int = bits_to_int(list(start_value)) & crc_mask
        final_xor_int = bits_to_int(list(final_xor)) & crc_mask
        probe = np.zeros((length + 1, length), dtype=np.uint8)
        probe[1:] = np.eye(length, dtype=np.uint8)
        order = _column_order(length, lsb_first)
        states = _evolve_states(probe, order, poly_int, crc_mask, start_int,
                                {len(order)})
        final = _finalize_vec(states[len(order)], width, final_xor_int,
                              rev_all, le)
        shifts = np.arange(width - 1, -1, -1)
        c0 = ((final[0] >> shifts) & 1).astype(np.uint8)
        g_ints = final[1:] ^ final[0]
        g = ((g_ints[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
        return g, c0

    zero = np.zeros(length, dtype=np.uint8)

    def crc_of(bits) -> np.ndarray:
        v = crc_int(bits, list(poly), list(start_value), list(final_xor),
                    lsb_first, rev_poly, rev_all, le)
        return np.array([(v >> (width - 1 - i)) & 1 for i in range(width)],
                        dtype=np.uint8)

    c0 = crc_of(zero)
    g = np.zeros((length, width), dtype=np.uint8)
    unit = zero.copy()
    for i in range(length):
        unit[i] = 1
        g[i] = crc_of(unit) ^ c0
        unit[i] = 0
    return g, c0


def batched_crc(messages: np.ndarray, polynomial, start_value, final_xor,
                lsb_first=False, reverse_polynomial=False, reverse_all=False,
                little_endian=False, device=None) -> np.ndarray:
    """CRC of N equal-length bit rows as one GF(2) matmul.

    messages: (N, L) uint8 bits.  Returns (N,) int64 CRC values.  The
    generator matrix is cached per (config, L); the matmul runs in
    float32 on 0/1 values (sums of at most L < 2^24 ones, exact), parity
    by & 1 after the cast back.
    """
    messages = np.asarray(messages, dtype=np.uint8)
    n, length = messages.shape
    if length >= _F32_EXACT:
        raise ValueError(f"messages of {length} bits: float32 sums are exact below 2^24")
    params = (tuple(int(b) for b in polynomial),
              tuple(int(b) for b in start_value),
              tuple(int(b) for b in final_xor),
              bool(lsb_first), bool(reverse_polynomial), bool(reverse_all),
              bool(little_endian))
    g, c0 = _crc_generator_matrix(params, length)
    width = g.shape[1]

    def run(dev):
        sums = _to(messages, dev).to(torch.float32) @ _to(g, dev).to(torch.float32)
        return (sums.round().to(torch.int32) & 1).cpu().numpy()

    bits = placement.run("awre.batched_crc_matmul", lambda: use_device(n * length), device, run)
    bits ^= c0.astype(np.int32)
    weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
    return bits.astype(np.int64) @ weights
