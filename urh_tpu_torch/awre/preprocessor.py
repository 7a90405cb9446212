"""awre preprocessing stage: preamble and sync-word identification.

Behavioral contract: urh/awre/Preprocessor.py (per-message byte scans
and pairwise Python loops).  This restructure turns the stage into a
handful of pure functions over the packed ``(N, L)`` message tensor:

* sync-word voting reuses the device difference matrix and the
  vectorized candidate extraction in :mod:`urh_tpu_torch.awre.kernels`;
* prefix merging of candidate words is one padded compare +
  accumulate instead of ``itertools.combinations`` + ``commonprefix``;
* the per-message ``bytes.find`` loops that align preambles against
  the chosen sync words become a single batched occurrence tensor
  (:func:`urh_tpu_torch.awre.device.occurrence_matrix`) followed by a
  vectorized byte/nibble-alignment preference reduction.

The thin :class:`Preprocessor` facade only wires these functions to
the ragged bitvector list and any pre-labeled message types.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.awre import device as awre_device
from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.protocol.labels import FieldType

_NGRAM = 4  # candidate sync words snap to this granularity
_NO_CAND = 1 << 30  # sentinel for "no candidate" in packed int arrays


# ---------------------------------------------------------------------------
# preamble structure
# ---------------------------------------------------------------------------


def _label_for(existing: dict, index: int, function) -> object:
    message_type = existing.get(index)
    if message_type is None:
        return None
    return message_type.get_first_label_with_type(function)


def preamble_structure(bitvectors: list, existing: dict) -> np.ndarray:
    """(N, 3) uint32: per message [start, lower_len, upper_len] of the
    detected a^n b^m preamble repetition; pre-labeled preambles win."""
    out = np.zeros((len(bitvectors), 3), dtype=np.uint32)
    for i, bits in enumerate(bitvectors):
        label = _label_for(existing, i, FieldType.Function.PREAMBLE)
        if label is None:
            start, lo, hi = awre_kernels.get_raw_preamble_position(bits)
        else:
            start, lo, hi = label.start, label.end, label.end
        out[i] = (start, lo - start, hi - start)
    return out


# ---------------------------------------------------------------------------
# sync-word voting
# ---------------------------------------------------------------------------


def _pack_words(words: list) -> tuple:
    """Pad 0/1-byte words into a (K, Lmax) uint8 matrix (+ lengths)."""
    lens = np.fromiter((len(w) for w in words), dtype=np.int64, count=len(words))
    mat = np.full((len(words), int(lens.max())), 255, dtype=np.uint8)
    for row, word in enumerate(words):
        mat[row, : lens[row]] = np.frombuffer(word, dtype=np.uint8)
    return mat, lens


def merge_by_prefix(scores: dict, min_len: int) -> dict:
    """Accumulate pair scores onto long common prefixes.

    For every unordered word pair whose common prefix exceeds
    ``min_len``, the prefix receives both scores; otherwise each word
    keeps its own.  (Words therefore accumulate once per pair they
    appear in — the voting is intentionally redundancy-weighted.)
    """
    if len(scores) < 2:
        return dict(scores)
    words = list(scores)
    weight = np.fromiter((scores[w] for w in words), dtype=np.float64,
                         count=len(words))
    mat, lens = _pack_words(words)

    # pairwise common-prefix lengths in one shot: position of the first
    # mismatch (or the full width when the rows agree everywhere)
    disagree = mat[:, None, :] != mat[None, :, :]
    prefix = disagree.argmax(axis=2)
    prefix[~disagree.any(axis=2)] = mat.shape[1]
    prefix = np.minimum(prefix, np.minimum(lens[:, None], lens[None, :]))

    merged: dict = {}
    rows, cols = np.triu_indices(len(words), k=1)
    pair_prefix = prefix[rows, cols]
    long_enough = pair_prefix > min_len

    # short pairs: each endpoint keeps its own score once per pair —
    # a bincount of endpoint occurrences replaces the Python pair loop
    # (K words -> K^2/2 pairs; the loop dominated FormatFinder)
    counts = np.bincount(
        np.concatenate([rows[~long_enough], cols[~long_enough]]),
        minlength=len(words))
    for i in np.flatnonzero(counts):
        merged[words[i]] = merged.get(words[i], 0) + weight[i] * counts[i]

    # long pairs: both scores onto the common prefix.  A pair's prefix
    # is fully determined by (word index of one endpoint, prefix
    # length), so a single O(pairs) bincount over K*(width+1) slots
    # aggregates everything with NO sort; equal prefixes from different
    # words then merge in the (small) dict by their bytes key.
    if long_enough.any():
        r_l = rows[long_enough]
        p_l = pair_prefix[long_enough]
        width = mat.shape[1]
        slots = r_l * (width + 1) + p_l
        sums = np.bincount(slots,
                           weights=weight[r_l] + weight[cols[long_enough]],
                           minlength=len(words) * (width + 1))
        for slot in np.flatnonzero(sums):
            r, p = divmod(int(slot), width + 1)
            key = words[r][:p]
            merged[key] = merged.get(key, 0) + sums[slot]
    return merged


def dominant_sync_length(scores: dict) -> int:
    """Highest-voted candidate length, nudged down to the nearest
    byte-aligned length when one scores nearby (within 7 bits)."""
    lens = np.fromiter((len(w) for w in scores), dtype=np.int64, count=len(scores))
    weight = np.fromiter(scores.values(), dtype=np.float64, count=len(scores))
    totals = np.zeros(int(lens.max()) + 1, dtype=np.float64)
    np.add.at(totals, lens, weight)

    present = np.flatnonzero(totals > 0)
    by_score = present[np.argsort(-totals[present], kind="stable")]
    best = int(by_score[0])
    if best % 8:
        gap = best - by_score
        aligned = by_score[(gap > 0) & (gap < 7) & (by_score % 8 == 0)]
        if len(aligned):
            best = int(aligned[0])
    return best


def rescue_missing_syncs(bitvectors: list, chosen: dict, scores: dict,
                         sync_len: int, device=None) -> dict:
    """Cover messages matched by none of the chosen sync words with
    truncated longer candidates (varying-preamble protocols)."""
    patterns = [np.frombuffer(w, dtype=np.uint8) for w in chosen]
    data, lengths = awre_device.pack_messages(bitvectors)
    uncovered = set(range(len(bitvectors)))
    if patterns:
        hits = awre_device.occurrence_matrix(data, lengths, patterns, device=device)
        uncovered -= set(np.flatnonzero(hits.any(axis=(1, 2))).tolist())
    if not uncovered:
        return {}

    longer = {w: s for w, s in scores.items()
              if len(w) > sync_len and not any(c in w for c in chosen)}
    extras: dict = {}
    for word in sorted(longer, key=longer.get, reverse=True):
        if not uncovered:
            break
        head = word[:sync_len]
        pattern = np.frombuffer(head, dtype=np.uint8)
        hit = awre_device.occurrence_matrix(data, lengths, [pattern],
                                            device=device).any(axis=(1, 2))
        matched = set(np.flatnonzero(hit).tolist()) & uncovered
        if matched:
            extras[head] = longer[word]
            uncovered -= matched
    return extras


def vote_sync_words(bitvectors: list, structure: np.ndarray,
                    n_gram_length: int = _NGRAM, device=None) -> list:
    """Rank sync-word candidates for the whole message set.

    Candidates come from n-gram windows between each message's preamble
    bounds and its first pairwise difference (device difference
    matrix); votes are merged by common prefix, the dominant length is
    chosen, and messages left without a sync are rescued with
    truncated longer candidates.  Returns 0/1 strings, best first.
    """
    diff = awre_kernels.get_difference_matrix(bitvectors, device)
    scores = awre_kernels.find_possible_sync_words(diff, structure, bitvectors,
                                                   n_gram_length)
    if not scores:
        return []
    scores = merge_by_prefix(scores, n_gram_length)
    sync_len = dominant_sync_length(scores)
    chosen = {w: s for w, s in scores.items() if len(w) == sync_len}
    chosen.update(rescue_missing_syncs(bitvectors, chosen, scores, sync_len, device))
    ranked = sorted(chosen, key=chosen.get, reverse=True)
    return ["".join(str(b) for b in word) for word in ranked]


# ---------------------------------------------------------------------------
# preamble/sync alignment
# ---------------------------------------------------------------------------


def sync_alignment_lengths(bitvectors: list, sync_words: list,
                           preamble_starts: np.ndarray, device=None) -> np.ndarray:
    """Per-message preamble length implied by the chosen sync words.

    One occurrence tensor yields, for every (message, sync word) pair,
    the first match and any echo within one word length of it; the
    distances back to the preamble start form the candidate lengths.
    Among candidates within 7 bits of the smallest, byte-aligned wins
    over nibble-aligned wins over smallest.
    """
    n = len(bitvectors)
    result = np.zeros(n, dtype=np.uint32)
    if n == 0 or not sync_words:
        return result
    word_len = len(sync_words[0])
    assert all(len(w) == word_len for w in sync_words)

    patterns = [np.fromiter(map(int, w), dtype=np.uint8, count=word_len)
                for w in sync_words]
    data, lengths = awre_device.pack_messages(bitvectors)
    hits = awre_device.occurrence_matrix(data, lengths, patterns, device=device)  # (N, K, S)
    n_msgs, n_words, n_starts = hits.shape
    col = np.arange(n_starts)

    # first occurrence per (message, word); echo = first hit in
    # (first, first + word_len] (a sync word may begin with the
    # preamble pattern, shifting the true boundary right)
    any_hit = hits.any(axis=2)
    first = np.where(any_hit, hits.argmax(axis=2), _NO_CAND)
    echo_window = (col[None, None, :] > first[:, :, None]) & \
                  (col[None, None, :] <= first[:, :, None] + word_len)
    echo_hits = hits & echo_window
    has_echo = echo_hits.any(axis=2)
    echo = np.where(has_echo, echo_hits.argmax(axis=2), _NO_CAND)

    cands = np.concatenate([first, echo], axis=1).astype(np.int64)  # (N, 2K)
    cands = cands - preamble_starts.astype(np.int64)[:, None]
    cands[cands < 2] = _NO_CAND  # too close to be a real preamble
    cands[cands >= _NO_CAND // 2] = _NO_CAND

    smallest = cands.min(axis=1)
    in_reach = cands < (smallest[:, None] + 7)
    cands = np.where(in_reach, cands, _NO_CAND)

    # preference rank: byte-aligned (0) < nibble-aligned (1) < rest (2)
    rank = np.where(cands % 8 == 0, 0, np.where(cands % 4 == 0, 1, 2))
    composite = rank.astype(np.int64) * _NO_CAND + cands
    pick = composite.min(axis=1)
    found = smallest < _NO_CAND
    result[found] = (pick[found] % _NO_CAND).astype(np.uint32)
    return result


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


class Preprocessor:
    """Wires the batched preamble/sync functions to a ragged bitvector
    list plus optionally pre-labeled message types."""

    def __init__(self, bitvectors: list, existing_message_types: dict = None, device=None):
        self.bitvectors = bitvectors
        self.device = device
        self.existing_message_types = dict(existing_message_types or {})

    def preprocess(self):
        structure = preamble_structure(self.bitvectors, self.existing_message_types)
        sync_words = self._labeled_sync_words()
        if not sync_words:
            sync_words = vote_sync_words(self.bitvectors, structure, device=self.device)
        starts = structure[:, 0]
        lengths = sync_alignment_lengths(self.bitvectors, sync_words, starts, self.device)
        return starts, lengths, (len(sync_words[0]) if sync_words else 0)

    def find_possible_syncs(self, raw_preamble_positions: np.ndarray = None):
        if raw_preamble_positions is None:
            raw_preamble_positions = preamble_structure(
                self.bitvectors, self.existing_message_types)
        return vote_sync_words(self.bitvectors, raw_preamble_positions, device=self.device)

    def _labeled_sync_words(self) -> list:
        # one word per DISTINCT sync (insertion-ordered): labels repeat
        # across every message of a type, and downstream occurrence
        # matching is O(words x messages)
        words = dict()
        for i, bits in enumerate(self.bitvectors):
            label = _label_for(self.existing_message_types, i,
                               FieldType.Function.SYNC)
            if label is not None:
                words["".join(map(str, bits[label.start : label.end]))] = None
        return list(words)
