"""FormatFinder: iterative protocol field inference.

Behavioral contract: urh/awre/FormatFinder.py (584 LoC of per-message
object scans).  Restructured around the batched awre pipeline: the
engines score candidate ranges for the *whole* message set at once on
device (:mod:`urh_tpu_torch.awre.device`); this module owns only the
host-side resolution, which runs on boolean matrices instead of
per-message loops:

* message-type partitioning builds a messages x ranges membership
  matrix and groups identical rows with one ``np.unique`` pass;
* overlap conflicts are resolved on the pairwise interval-overlap
  matrix (chains = consecutive overlapping intervals; each anchor's
  greedy candidate set is a row of the negated matrix);
* preamble/sync ranges and engine-local index retransformation group
  by ``np.unique`` over (start, length, sync-end) keys.
"""

from __future__ import annotations

import copy
import math
from collections import defaultdict

import numpy as np

from urh_tpu_torch.awre import auto_assigner
from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.awre.common_range import (ChecksumRange, CommonRange,
                                       CommonRangeContainer, EmptyCommonRange)
from urh_tpu_torch.awre.engines.address import AddressEngine
from urh_tpu_torch.awre.engines.checksum import ChecksumEngine
from urh_tpu_torch.awre.engines.length import LengthEngine
from urh_tpu_torch.awre.engines.sequence_number import SequenceNumberEngine
from urh_tpu_torch.awre.preprocessor import Preprocessor
from urh_tpu_torch.coding.wsp import WSPChecksum
from urh_tpu_torch.protocol.labels import ChecksumLabel, FieldType, MessageType
from urh_tpu_torch.util import placement

_F = FieldType.Function


def _snap_sync_ends(preamble_starts, preamble_lengths, sync_len,
                    field_granularity):
    """Vectorized sync-end snapping: underestimate each message's sync
    end to the field granularity (never past the preamble start)."""
    starts = preamble_starts.astype(np.int64)
    rel = preamble_lengths.astype(np.int64) + sync_len
    if field_granularity > 0:
        snapped = field_granularity * np.maximum(rel // field_granularity, 1)
    else:
        snapped = np.zeros_like(rel)
    sync_ends = starts + snapped
    plens = np.minimum(preamble_lengths.astype(np.int64), snapped)
    return sync_ends.astype(np.uint32), plens.astype(np.uint32)


class FormatFinder:
    MIN_MESSAGES_PER_CLUSTER = 2

    def __init__(self, messages, participants=None, shortest_field_length=None, device=None):
        # every engine's batched programs run here: the CUDA card by
        # default, RuntimeError without one (pass device="cpu"); "auto" is
        # kept and handed on, so that each call is placed
        self.device = placement.requested(device)
        if participants is not None:
            auto_assigner.auto_assign_participants(messages, participants)

        types_by_message = {i: m.message_type for i, m in enumerate(messages)}
        self.existing_message_types = defaultdict(list)
        for i, message_type in types_by_message.items():
            self.existing_message_types[message_type].append(i)

        stage = Preprocessor(self.get_bitvectors_from_messages(messages),
                             types_by_message, self.device)
        self.preamble_starts, raw_lengths, sync_len = stage.preprocess()

        if shortest_field_length is None:
            # granularity by confidence in the sync: byte > nibble > bit
            shortest_field_length = next(
                (g for g in (8, 4, 1) if sync_len >= g), 0)
        self.sync_ends, self.preamble_lengths = _snap_sync_ends(
            self.preamble_starts, raw_lengths, sync_len, shortest_field_length)

        self.bitvectors = self.get_bitvectors_from_messages(messages, self.sync_ends)
        self.hexvectors = self.get_hexvectors(self.bitvectors, self.device)
        self.current_iteration = 0

        roster = sorted(set(m.participant for m in messages
                            if m.participant is not None))
        self.participant_indices = [
            roster.index(m.participant) if m.participant is not None else -1
            for m in messages]
        self.known_participant_addresses = {
            roster.index(p): np.array([int(h, 16) for h in p.address_hex],
                                      dtype=np.uint8)
            for p in roster if p and p.address_hex}

    @property
    def message_types(self):
        return sorted(self.existing_message_types.keys(), key=lambda t: t.name)

    # -- engine dispatch -----------------------------------------------------

    def _engines_for(self, message_type: MessageType, indices: list) -> list:
        """Instantiate one engine per field type the message type still
        lacks; all engines consume the same batched vector views."""
        sync_end = self.sync_ends[indices[0]] if indices else 0
        labeled = [(lbl.start - sync_end, lbl.end - sync_end)
                   for lbl in message_type if lbl.start >= sync_end]
        bits = [self.bitvectors[i] for i in indices]

        def address(src_present=False):
            return AddressEngine([self.hexvectors[i] for i in indices],
                                 [self.participant_indices[i] for i in indices],
                                 self.known_participant_addresses,
                                 already_labeled=labeled,
                                 src_field_present=src_present, device=self.device)

        engines = []
        if not message_type.get_first_label_with_type(_F.LENGTH):
            engines.append(LengthEngine(bits, already_labeled=labeled, device=self.device))
        if not message_type.get_first_label_with_type(_F.SRC_ADDRESS):
            engines.append(address())
        elif not message_type.get_first_label_with_type(_F.DST_ADDRESS):
            engines.append(address(src_present=True))
        if not message_type.get_first_label_with_type(_F.SEQUENCE_NUMBER):
            engines.append(SequenceNumberEngine(bits, already_labeled=labeled,
                                                device=self.device))
        # checksums either surface immediately or never
        if (not message_type.get_first_label_with_type(_F.CHECKSUM)
                and self.current_iteration == 0):
            engines.append(ChecksumEngine(bits, already_labeled=labeled, device=self.device))
        return engines

    def perform_iteration_for_message_type(self, message_type: MessageType):
        """One inference pass over all messages of one type; returns the
        newly found fields as CommonRanges in global coordinates."""
        indices = self.existing_message_types[message_type]
        found = set()
        for engine in self._engines_for(message_type, indices):
            local = engine.find()
            global_ranges = self.retransform_message_indices(
                local, indices, self.sync_ends)
            found.update(self.merge_common_ranges(global_ranges))
        return found

    def perform_iteration(self) -> bool:
        anything_new = False
        for message_type in self.existing_message_types.copy():
            indices = self.existing_message_types[message_type]
            fields = self.perform_iteration_for_message_type(message_type)
            fields.update(self.get_preamble_and_sync(
                self.preamble_starts, self.preamble_lengths, self.sync_ends,
                message_type_indices=indices))

            self.remove_overlapping_fields(fields, message_type)
            containers = self.create_common_range_containers(fields)
            self._learn_addresses(containers)
            anything_new |= bool(containers)
            self._apply_containers(message_type, containers)
        return anything_new

    def _learn_addresses(self, containers):
        """Harvest source-address values of resolved containers as the
        addresses of participants we do not know yet."""
        unknown = set(self.participant_indices) - set(self.known_participant_addresses)
        unknown.discard(-1)
        if not unknown:
            return
        for container in containers:
            src = next((r for r in container if r.field_type == "source address"),
                       None)
            if src is None:
                continue
            for msg_index in src.message_indices:
                if not unknown:
                    return
                p = self.participant_indices[msg_index]
                if p in unknown:
                    nibbles = self.hexvectors[msg_index]
                    self.known_participant_addresses[p] = \
                        nibbles[src.start : src.end + 1]
                    unknown.discard(p)

    def _apply_containers(self, message_type: MessageType, containers):
        """One container extends the type in place; several split it."""
        if len(containers) == 1:
            for rng in containers[0]:
                self.add_range_to_message_type(rng, message_type)
        elif len(containers) > 1:
            del self.existing_message_types[message_type]
            for i, container in enumerate(containers):
                split = copy.deepcopy(message_type)
                if i > 0:
                    split.name = "Message Type {}.{}".format(
                        self.current_iteration + 1, i)
                    split.give_new_id()
                for rng in container:
                    self.add_range_to_message_type(rng, split)
                self.existing_message_types[split].extend(
                    sorted(container.message_indices))

    def run(self, max_iterations=10):
        self.current_iteration = 0
        while self.perform_iteration() and self.current_iteration < max_iterations:
            self.current_iteration += 1
        if self.message_types:
            # park messages no container claimed on the first type
            claimed = set(i for members in self.existing_message_types.values()
                          for i in members)
            orphans = set(range(len(self.bitvectors))) - claimed
            self.existing_message_types[self.message_types[0]].extend(orphans)

    # -- range resolution (matrix formulations) ------------------------------

    @staticmethod
    def remove_overlapping_fields(common_ranges, message_type: MessageType):
        """Drop candidates that collide with already-assigned labels."""
        if len(message_type) == 0 or not common_ranges:
            return
        label_starts = np.array([lbl.start for lbl in message_type])
        label_ends = np.array([lbl.end for lbl in message_type])
        for rng in list(common_ranges):
            if np.any((rng.bit_start < label_ends) & (label_starts < rng.bit_end)):
                common_ranges.discard(rng)

    @staticmethod
    def merge_common_ranges(common_ranges):
        """Fuse ranges sharing (bit interval, field type), pooling their
        values and message indices."""
        by_key = {}
        for rng in common_ranges:
            assert isinstance(rng, CommonRange)
            key = (rng.bit_start, rng.bit_end, rng.field_type)
            kept = by_key.get(key)
            if kept is None:
                by_key[key] = rng
            else:
                kept.values.extend(rng.values)
                kept.message_indices.update(rng.message_indices)
        return list(by_key.values())

    @staticmethod
    def create_common_range_containers(label_set: set, num_messages: int = None):
        """Group messages by the exact set of ranges claiming them.

        Builds the messages x ranges membership matrix and unifies equal
        rows (one np.unique) — each distinct row is a message-type
        candidate.  Conflicting (overlapping) range sets are resolved
        afterwards.
        """
        ranges = [r for r in label_set if not isinstance(r, EmptyCommonRange)]
        if num_messages is None:
            message_ids = sorted(set(i for r in ranges for i in r.message_indices))
        else:
            message_ids = list(range(num_messages))
        id_pos = {m: i for i, m in enumerate(message_ids)}

        member = np.zeros((len(message_ids), len(ranges)), dtype=bool)
        for j, rng in enumerate(ranges):
            rows = [id_pos[i] for i in rng.message_indices if i in id_pos]
            member[rows, j] = True

        containers = []
        if len(message_ids):
            patterns, inverse = np.unique(member, axis=0, return_inverse=True)
            order = np.argsort([np.flatnonzero(inverse == g)[0]
                                for g in range(len(patterns))])
            for g in order:
                group_rows = np.flatnonzero(inverse == g)
                bundle = sorted(ranges[j] for j in np.flatnonzero(patterns[g]))
                containers.append(CommonRangeContainer(
                    bundle, message_indices={message_ids[r] for r in group_rows}))

        return FormatFinder.handle_overlapping_conflict(containers)

    @staticmethod
    def handle_overlapping_conflict(containers):
        """Resolve overlaps inside each container, then unify containers
        that collapsed onto the same range set."""
        result = []
        for container in containers:
            if container.ranges_overlap:
                container = FormatFinder._resolve_container_overlaps(container)
            twin = next((c for c in result
                         if c.has_same_ranges_as_container(container)), None)
            if twin is None:
                result.append(container)
            else:
                twin.message_indices.update(container.message_indices)
        return result

    @staticmethod
    def _resolve_container_overlaps(container: CommonRangeContainer):
        """Pick a high-scoring non-conflicting subset of the container.

        Overlap structure is one boolean matrix; maximal chains of
        consecutively-overlapping intervals are segmented off it, and
        within each chain every member anchors a greedy candidate set
        (itself plus all later members clear of the anchor).  The best
        set wins by (total score, shorter total length, has a length
        field, field-type names).
        """
        ranges = list(container)
        starts = np.array([r.bit_start for r in ranges])
        ends = np.array([r.bit_end for r in ranges])
        overlap = (starts[:, None] < ends[None, :]) & (starts[None, :] < ends[:, None])

        chain_breaks = [i for i in range(1, len(ranges))
                        if not overlap[i, i - 1]]
        chain_bounds = [0] + chain_breaks + [len(ranges)]

        survivors = []
        for lo, hi in zip(chain_bounds[:-1], chain_bounds[1:]):
            candidates = []
            for anchor in range(lo, hi):
                picked = [ranges[anchor]] + [
                    ranges[j] for j in range(anchor + 1, hi)
                    if not overlap[anchor, j]]
                candidates.append(picked)
            best = max(candidates, key=lambda sol: (
                sum(r.score for r in sol),
                -sum(int(r.length_in_bits) for r in sol),
                "length" in {r.field_type for r in sol},
                "".join(r.field_type[0] for r in sol)))
            survivors.extend(best)

        return CommonRangeContainer(survivors,
                                    message_indices=container.message_indices)

    @staticmethod
    def retransform_message_indices(common_ranges, message_type_indices: list,
                                    sync_ends) -> list:
        """Map engine-local message indices to global ones, splitting
        each range per distinct sync end (one unique/groupby)."""
        lookup = np.asarray(message_type_indices, dtype=int)
        result = []
        for rng in common_ranges:
            global_ids = lookup[sorted(rng.message_indices)]
            ends_here = np.asarray(sync_ends)[global_ids]
            for sync_end in np.unique(ends_here):
                clone = copy.deepcopy(rng)
                clone.sync_end = sync_end
                clone.message_indices = set(global_ids[ends_here == sync_end])
                result.append(clone)
        return result

    @staticmethod
    def get_preamble_and_sync(preamble_starts, preamble_lengths, sync_ends,
                              message_type_indices):
        """Preamble + sync CommonRanges, one per distinct geometry.

        Messages sharing (start, length) collapse into one range via a
        unique/groupby instead of per-message set membership tests.
        """
        assert len(preamble_starts) == len(preamble_lengths) == len(sync_ends)
        ids = np.asarray(list(message_type_indices), dtype=int)
        if len(ids) == 0:
            return set()

        result = set()
        specs = (
            ("preamble", preamble_starts[ids], preamble_lengths[ids]),
            ("synchronization", preamble_starts[ids] + preamble_lengths[ids],
             sync_ends[ids] - (preamble_starts[ids] + preamble_lengths[ids])),
        )
        for field_type, starts, lengths in specs:
            geometry = np.stack([starts, lengths], axis=1)
            uniq, inverse = np.unique(geometry, axis=0, return_inverse=True)
            for g, (start, length) in enumerate(uniq):
                if length <= 0:
                    continue
                result.add(CommonRange(
                    int(start), int(length), field_type=field_type,
                    message_indices=set(ids[inverse == g].tolist())))
        return result

    # -- vector views ---------------------------------------------------------

    @staticmethod
    def get_hexvectors(bitvectors: list, device=None):
        return awre_kernels.get_hexvectors(bitvectors, device)

    @staticmethod
    def get_bitvectors_from_messages(messages: list, sync_ends: np.ndarray = None):
        if sync_ends is None:
            sync_ends = defaultdict(lambda: None)
        return [np.array(msg.decoded_bits[sync_ends[i] :], dtype=np.uint8, order="C")
                for i, msg in enumerate(messages)]

    @staticmethod
    def add_range_to_message_type(common_range: CommonRange,
                                  message_type: MessageType):
        field_type = FieldType.from_caption(common_range.field_type)
        label = message_type.add_protocol_label(
            name=common_range.field_type, start=common_range.bit_start,
            end=common_range.bit_end, auto_created=True, type=field_type)
        label.display_endianness = common_range.byte_order

        if field_type.function == _F.CHECKSUM:
            assert isinstance(label, ChecksumLabel)
            assert isinstance(common_range, ChecksumRange)
            label.data_ranges = [[common_range.data_range_bit_start,
                                  common_range.data_range_bit_end]]
            if isinstance(common_range.crc, WSPChecksum):
                label.category = ChecksumLabel.Category.wsp
            else:
                label.checksum = copy.copy(common_range.crc)
