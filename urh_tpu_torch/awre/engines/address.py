"""Address-field inference.

Behavioral contract: urh/awre/engines/AddressEngine.py — addresses are
hex-level values that (a) recur inside a participant's own messages and
in messages directed at it, (b) appear cross-swapped between two
participants' traffic (my SRC is your DST), and (c) for ACKs sit at the
same offset with different values.

Dataflow here: candidate address strings come from LCS over per-
participant constant ranges; then ONE batched device occurrence search
(urh_tpu_torch.awre.kernels.batch_find_occurrences) places every candidate in
every message at once, and the host only scores interactions and
resolves the participant↔address assignment.
"""

from __future__ import annotations

import itertools
from collections import Counter, defaultdict

import numpy as np

from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.awre.common_range import CommonRange
from urh_tpu_torch.awre.engines.engine import Engine

MIN_SCORE = 0.1
ASSIGN_MIN_SCORE = 0.5
KNOWN_ADDRESS_WEIGHT = 9999999999


def _hex_cols(bit_spans) -> list:
    """Bit spans -> hex-column spans (ceil on both edges, like the
    reference's already-labeled conversion).  Plain ints: numpy unsigned
    scalars overflow under negation."""
    return [(-(-int(lo) // 4), -(-int(hi) // 4)) for lo, hi in bit_spans]


def _is_cross_swap(a: CommonRange, b: CommonRange) -> bool:
    """Same value at offsets shifted by exactly one address length."""
    return (a.start in (b.start + a.length, b.start - a.length)
            and a.value.tobytes() == b.value.tobytes())


def _is_ack_pair(a: CommonRange, b: CommonRange) -> bool:
    """Same slot, different value: request/acknowledge flip."""
    return (a.start == b.start and a.length == b.length
            and a.value.tobytes() != b.value.tobytes())


class AddressEngine(Engine):
    def __init__(self, msg_vectors, participant_indices,
                 known_participant_addresses: dict = None,
                 already_labeled: list = None, src_field_present=False, device=None):
        assert len(msg_vectors) == len(participant_indices)
        self.device = device
        self.minimum_score = MIN_SCORE
        self.msg_vectors = msg_vectors
        self.participant_indices = participant_indices
        self.src_field_present = src_field_present
        self.already_labeled = _hex_cols(already_labeled or [])
        self.known_addresses_by_participant = dict(known_participant_addresses or {})

        self.message_indices_by_participant = defaultdict(list)
        for i, participant in enumerate(participant_indices):
            self.message_indices_by_participant[participant].append(i)

    # reference-API aliases used by tests
    @staticmethod
    def cross_swap_check(rng1, rng2):
        return _is_cross_swap(rng1, rng2)

    @staticmethod
    def ack_check(rng1, rng2):
        return _is_ack_pair(rng1, rng2)

    # ------------------------------------------------------------------
    # stage 1: candidate address generation
    # ------------------------------------------------------------------

    def find_addresses(self) -> dict:
        """Candidate address byte-strings per participant, from LCS over
        each participant's constant ranges."""
        unknown = [p for p in self.message_indices_by_participant
                   if p not in self.known_addresses_by_participant]
        if not unknown:
            self._debug("skip find_addresses: all known")
            return dict()

        constant_values = self._constant_values_per_participant()
        participants = sorted(constant_values)
        candidates = defaultdict(set)
        if len(participants) < 2:
            return candidates

        known = self.known_addresses_by_participant
        required_len = (len(next(iter(known.values()))) if known else None)

        for p1, p2 in itertools.combinations(participants, 2):
            if p1 in known and p2 in known:
                continue
            for seq1, seq2 in itertools.product(constant_values[p1],
                                                constant_values[p2]):
                shared = self.find_longest_common_sub_sequences(seq1, seq2)
                pool = shared if shared else [seq1, seq2]
                for val in pool:
                    # an address is at least 2 hex digits
                    if len(val) < 2:
                        continue
                    if required_len is not None and len(val) != required_len:
                        continue
                    blob = val.tobytes()
                    if p1 in known:
                        if blob != known[p1].tobytes():
                            candidates[p2].add(blob)
                    elif p2 in known:
                        if blob != known[p2].tobytes():
                            candidates[p1].add(blob)
                    else:
                        candidates[p1].add(blob)
                        candidates[p2].add(blob)
        return candidates

    def _constant_values_per_participant(self) -> dict:
        """Values of within-length-cluster constant ranges, per participant,
        trimmed around already-labeled columns."""
        result = {}
        for participant, indices in self.message_indices_by_participant.items():
            by_length = defaultdict(list)
            for i in indices:
                by_length[len(self.msg_vectors[i])].append(i)
            clustered = self.find_common_ranges_by_cluster(
                self.msg_vectors, by_length, range_type="hex", device=self.device)
            values = []
            for ranges in clustered.values():
                values.extend(r.value for r in
                              self.ignore_already_labeled(ranges, self.already_labeled))
            result[participant] = values
        return result

    # ------------------------------------------------------------------
    # stage 2: batched placement of candidates in all messages
    # ------------------------------------------------------------------

    def _place_candidates(self, candidate_blobs: list) -> dict:
        """ranges_by_participant from one device occurrence search."""
        arrays = [np.frombuffer(b, dtype=np.uint8) for b in candidate_blobs]
        ignore = [col for span in self.already_labeled for col in range(*span)]
        hits = awre_kernels.batch_find_occurrences(self.msg_vectors, arrays,
                                                   ignore_columns=ignore, device=self.device)
        ranges_by_participant = defaultdict(list)
        for i in range(len(self.msg_vectors)):
            participant = self.participant_indices[i]
            bucket = ranges_by_participant[participant]
            for k, address in enumerate(arrays):
                for start in hits.get((i, k), []):
                    placed = next((r for r in bucket if r.matches(start, address)),
                                  None)
                    if placed is None:
                        bucket.append(CommonRange(start, len(address), address,
                                                  message_indices={i},
                                                  range_type="hex"))
                    else:
                        placed.message_indices.add(i)
        return ranges_by_participant

    # ------------------------------------------------------------------
    # stage 3: interaction scoring
    # ------------------------------------------------------------------

    def _score_interactions(self, ranges_by_participant: dict):
        msg_count = Counter(self.participant_indices)
        for p1, p2 in itertools.combinations(ranges_by_participant, 2):
            set1 = set(ranges_by_participant[p1])
            set2 = set(ranges_by_participant[p2])
            for rng1, rng2 in itertools.product(ranges_by_participant[p1],
                                                ranges_by_participant[p2]):
                if rng1 not in set2 or rng2 not in set1:
                    continue  # slot must exist on both sides
                if _is_cross_swap(rng1, rng2):
                    rng1.score += len(rng2.message_indices) / msg_count[p2]
                    rng2.score += len(rng1.message_indices) / msg_count[p1]
                elif _is_ack_pair(rng1, rng2):
                    # the current score in the divisor favors ranges that
                    # already apply to many messages
                    rng1.score += len(rng2.message_indices) / (msg_count[p2] + rng1.score)
                    rng2.score += len(rng1.message_indices) / (msg_count[p1] + rng2.score)

    def _boost_known_address_single_participant(self, ranges_by_participant: dict):
        """With only one participant talking, high-score its leftmost range
        matching the already known address."""
        for p, bucket in ranges_by_participant.items():
            known = self.known_addresses_by_participant.get(p)
            if known is None:
                continue
            for rng in sorted(bucket):
                if np.array_equal(rng.value, known):
                    rng.score = 1
                    break

    # ------------------------------------------------------------------
    # stage 4: length vote + selection
    # ------------------------------------------------------------------

    def _vote_address_length(self, ranges_by_participant: dict) -> int:
        """Majority vote over each participant's top-scored range lengths,
        demoting ranges whose value merely contains several smaller
        co-occurring candidates."""
        votes = []
        for bucket in ranges_by_participant.values():
            ranked = sorted((r for r in bucket if r.score > self.minimum_score),
                            key=lambda r: (-r.score, r))
            if not ranked:
                continue
            leaders = [r for r in ranked if r.score == ranked[0].score]
            for leader in leaders[:]:
                siblings = [r for r in ranked
                            if r not in leaders and r.score > 0
                            and r.message_indices == leader.message_indices]
                if len(siblings) > 1 and all(
                        s.value.tobytes() in leader.value.tobytes()
                        for s in siblings):
                    # leader is probably a concatenation of real addresses
                    leaders.remove(leader)
                    leaders.extend(siblings)
            tally = Counter(r.length for r in leaders)
            if tally:
                votes.append(max(tally, key=lambda ln: (tally[ln], -ln)))

        overall = Counter(votes)
        if not overall:
            return 0
        return max(overall, key=lambda ln: (overall[ln], -ln))

    # ------------------------------------------------------------------
    # stage 5: participant <-> address assignment
    # ------------------------------------------------------------------

    def _assign_addresses(self, candidate_sets: dict, high_ranges: dict) -> dict:
        """Pick one address per participant (or None)."""
        weights = {p: defaultdict(int) for p in candidate_sets}

        for participant, pool in candidate_sets.items():
            if participant in self.known_addresses_by_participant:
                blob = self.known_addresses_by_participant[participant].tobytes()
                weights[participant][blob] = KNOWN_ADDRESS_WEIGHT
                continue

            for i in self.message_indices_by_participant[participant]:
                present = [r for r in high_ranges[participant]
                           if i in r.message_indices and r.value.tobytes() in pool]
                if len(present) > 1:
                    # several addresses in one message: the SRC is among them
                    for rng in present:
                        weights[participant][rng.value.tobytes()] += rng.score
                elif len(present) == 1:
                    blob = present[0].value.tobytes()
                    # a lone address is probably the DST, not this
                    # participant's own
                    weights[participant][blob] *= 0.9
                    # ...unless this is an ACK: then it names the previous
                    # sender, crediting THAT participant
                    prev = self.participant_indices[i - 1] if i > 0 else participant
                    if prev != participant:
                        prev_present = [r for r in high_ranges[prev]
                                        if i - 1 in r.message_indices
                                        and r.value.tobytes() in pool]
                        if len(prev_present) > 1:
                            for rng in prev_present:
                                if rng.value.tobytes() == blob:
                                    weights[prev][blob] += rng.score

        self._debug("Scored addresses", weights)

        # fast path: every participant has exactly one distinct candidate
        if all(len(w) == 1 for w in weights.values()):
            picks = {p: next(iter(w)) for p, w in weights.items()}
            if len(set(picks.values())) == len(picks):
                return picks

        assigned = {}
        taken = set()
        for participant, w in sorted(weights.items()):
            viable = sorted((b for b in w
                             if b not in taken and w[b] >= ASSIGN_MIN_SCORE),
                            reverse=True)
            if not viable:
                assigned[participant] = None
                continue
            best = max(viable, key=w.get)
            assigned[participant] = best
            taken.add(best)
        return assigned

    # ------------------------------------------------------------------
    # stage 6: SRC/DST labeling + broadcast
    # ------------------------------------------------------------------

    @staticmethod
    def _label_src_dst(bucket: list, own_address: bytes) -> list:
        """Type each range SRC/DST and drop redundant or non-adjacent
        duplicates."""
        kept = []
        for rng in sorted(bucket, key=lambda r: r.score, reverse=True):
            rng.field_type = ("source address"
                              if rng.value.tobytes() == own_address
                              else "destination address")
            enclosing = next((k for k in kept
                              if rng.message_indices.issubset(k.message_indices)),
                             None)
            if enclosing is not None:
                if enclosing.field_type == rng.field_type:
                    continue  # second SRC (or DST) adds nothing
                adjacent = (rng.length == enclosing.length
                            and (rng.start == enclosing.end + 1
                                 or rng.end + 1 == enclosing.start))
                if not adjacent:
                    continue  # SRC and DST must sit side by side
            kept.append(rng)
        return kept

    def _mark_broadcast(self, high_ranges: dict, assigned: dict):
        """SRC-only messages whose would-be DST slot holds one common value
        reveal a broadcast address."""
        if -1 in assigned:
            return

        dst_candidates = defaultdict(list)
        for bucket in high_ranges.values():
            srcs = sorted(r for r in bucket if r.field_type == "source address")
            dsts = sorted(r for r in bucket if r.field_type == "destination address")
            covered = {i for d in dsts for i in d.message_indices}

            for src in srcs:
                uncovered = {i for i in src.message_indices if i not in covered}
                if not uncovered:
                    continue
                slot = next((d for d in dsts
                             if (src.message_indices - uncovered)
                             <= d.message_indices), None)
                if slot is None:
                    continue
                dst_candidates[slot].extend(uncovered)

        if not dst_candidates:
            return

        broadcast = None
        for slot, indices in dst_candidates.items():
            for i in indices:
                value = self.msg_vectors[i][slot.start : slot.end + 1]
                if broadcast is None:
                    broadcast = value
                elif value.tobytes() != broadcast.tobytes():
                    return  # values differ -> no broadcast
        assigned[-1] = broadcast.tobytes()
        for slot, indices in dst_candidates.items():
            slot.values.append(broadcast)
            slot.message_indices.update(indices)

    # ------------------------------------------------------------------
    # orchestration
    # ------------------------------------------------------------------

    def find(self):
        candidates = {p: [addr.tobytes()]
                      for p, addr in self.known_addresses_by_participant.items()}
        candidates.update(self.find_addresses())
        self._debug("Addresses by participant", candidates)

        flat = []
        for pool in candidates.values():
            for blob in pool:
                if blob not in flat:
                    flat.append(blob)

        ranges_by_participant = self._place_candidates(flat)
        self._score_interactions(ranges_by_participant)
        if len(ranges_by_participant) == 1 and not self.src_field_present:
            self._boost_known_address_single_participant(ranges_by_participant)

        address_length = self._vote_address_length(ranges_by_participant)

        high_ranges = defaultdict(list)
        candidate_sets = dict(candidates)
        for participant, bucket in ranges_by_participant.items():
            ranked = sorted((r for r in bucket if r.score > self.minimum_score),
                            key=lambda r: (-r.score, r))
            if not ranked:
                candidate_sets[participant] = dict()
                continue
            candidate_sets[participant] = {
                b for b in candidate_sets.get(participant, [])
                if len(b) == address_length}
            for rng in ranked:
                if rng.length == address_length:
                    rng.score = min(rng.score, 1.0)
                    high_ranges[participant].append(rng)

        assigned = self._assign_addresses(candidate_sets, high_ranges)
        assigned = {p: a for p, a in assigned.items() if a is not None}

        for participant in list(high_ranges):
            own = assigned.get(participant)
            if own is None:
                high_ranges[participant] = []
                continue
            high_ranges[participant] = self._label_src_dst(
                high_ranges[participant], own)

        self._mark_broadcast(high_ranges, assigned)

        result = [rng for bucket in high_ranges.values() for rng in bucket]
        if not any(r.field_type == "source address" for r in result):
            # without a SRC the evidence is weaker; don't let DST win ties
            for rng in result:
                rng.score *= 0.95
        return result
