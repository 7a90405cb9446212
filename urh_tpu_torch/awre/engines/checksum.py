"""Checksum-field inference.

Behavioral contract: urh/awre/engines/ChecksumEngine.py — per
message-length cluster, find a (data range, checksum range, CRC config)
hypothesis per message (EnOcean WSP first, then the standard-CRC
search), pool identical hypotheses, extend each over the whole cluster
with the batched GF(2) CRC check, and keep only hypotheses using the
cluster-dominant CRC.
"""

from __future__ import annotations

import array
import copy
import math
from collections import defaultdict

from urh_tpu_torch.awre import crc_search
from urh_tpu_torch.awre import kernels as awre_kernels
from urh_tpu_torch.awre.common_range import ChecksumRange
from urh_tpu_torch.awre.engines.engine import Engine
from urh_tpu_torch.coding.crc import GenericCRC
from urh_tpu_torch.coding.wsp import WSPChecksum


class ChecksumEngine(Engine):
    def __init__(self, bitvectors, n_gram_length=8, minimum_score=0.9,
                 already_labeled: list = None, device=None):
        self.bitvectors = bitvectors
        self.device = device
        self.n_gram_length = n_gram_length
        self.minimum_score = minimum_score
        spans = already_labeled or []
        self.already_labeled_cols = {pos for lo, hi in spans
                                     for pos in range(lo, hi)}

    def find(self):
        clusters = defaultdict(list)
        for i, bv in enumerate(self.bitvectors):
            clusters[int(math.ceil(len(bv) / self.n_gram_length))].append(i)

        cluster_best = []
        for gram_count, members in clusters.items():
            # WSP candidates per message; everything else goes through the
            # batched standard-CRC sweep (one set of array passes for the
            # whole cluster instead of per-message bitwise loops)
            wsp_hits = {}
            crc_candidates = []
            for index in members:
                spans = WSPChecksum.search_for_wsp_checksum(
                    array.array("B", self.bitvectors[index]))
                if spans != (0, 0, 0, 0):
                    wsp_hits[index] = spans
                else:
                    crc_candidates.append(index)
            crc_hits = crc_search.batched_guess_all(
                self.bitvectors, crc_candidates,
                ignore_positions=self.already_labeled_cols)
            packed = awre_kernels.pack_indices_by_length(self.bitvectors,
                                                         members)

            hypotheses = []
            pooled_by_key = {}
            for index in members:
                hyp = self._hypothesis_from_hits(index, wsp_hits, crc_hits,
                                                 len(members))
                if hyp is None:
                    continue
                pooled = pooled_by_key.get(hyp)
                if pooled is not None:
                    pooled.message_indices.add(index)
                    continue
                pooled_by_key[hyp] = hyp
                hypotheses.append(hyp)
                if not isinstance(hyp.crc, WSPChecksum):
                    # one GF(2) matmul extends the hypothesis cluster-wide
                    hyp.message_indices.update(
                        awre_kernels.check_crc_for_messages_packed(
                            packed, hyp.data_range_start, hyp.data_range_end,
                            hyp.start, hyp.start + hyp.length,
                            *hyp.crc.get_parameters(), device=self.device))

            for hyp in hypotheses:
                hyp.score = len(hyp.message_indices) / len(members)
            if hypotheses:
                cluster_best.append(max(hypotheses, key=lambda h: h.score))

        dominant = [h for h in cluster_best
                    if len(h.message_indices) >= 2 and h.score >= self.minimum_score]
        if not dominant:
            return []
        anchor = max(dominant, key=lambda h: h.score)
        return [h for h in cluster_best if h.crc == anchor.crc]

    def _hypothesis_from_hits(self, index: int, wsp_hits: dict,
                              crc_hits: dict, cluster_size: int):
        """One message's (data range, crc range, config) candidate, WSP
        preferred over generic CRCs."""
        if index in wsp_hits:
            data_lo, data_hi, crc_lo, crc_hi = wsp_hits[index]
            return ChecksumRange(
                start=crc_lo, length=crc_hi - crc_lo,
                data_range_start=data_lo, data_range_end=data_hi,
                crc=WSPChecksum(), score=1 / cluster_size,
                field_type="checksum", message_indices={index})

        found = crc_hits.get(index)
        if found is None:
            return None
        config, data_lo, data_hi, crc_lo, crc_hi = found
        return ChecksumRange(
            start=crc_lo, length=crc_hi - crc_lo,
            data_range_start=data_lo, data_range_end=data_hi,
            crc=copy.copy(config), score=1 / cluster_size,
            field_type="checksum", message_indices={index})
