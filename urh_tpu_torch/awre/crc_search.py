"""Batched CRC reverse-search: GenericCRC.guess_all over a whole message
cluster as array sweeps instead of per-message bitwise loops.

The reference runs its checksum search one message at a time through
Cython (GenericCRC.py:444-523 over util.pyx:216-304).  Here the search
is re-shaped for arrays: messages of equal length form a (B, L) bit
matrix; for every standard CRC config the state evolution runs once as
column-parallel int64 ops over all B messages, the message-independent
impulse-delta table (``steps``) is built once, and the reference's
peel-from-the-front scan becomes a masked XOR prefix-scan + first-match
reduction.  Semantics are bit-faithful to coding/crc.get_crc_datarange
(including its documented upstream-bug parity quirks) — verified by the
fuzz test against the scalar implementation.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.coding.crc import (GenericCRC, _little_endian_swap, _reflect,
                                bit_column_order, bits_to_int)


def _configs_in_priority_order():
    """Standard configs exactly as guess_standard_parameters_and_datarange
    iterates them: poly length descending, insertion order for ties."""
    GenericCRC._initialize_standard_checksums()
    items = sorted(GenericCRC.STANDARD_CHECKSUMS.items(),
                   key=lambda x: len(x[1]["polynomial"]), reverse=True)
    configs = []
    for name, p in items:
        configs.append({
            "name": name,
            "polynomial": np.asarray(p["polynomial"], dtype=np.uint8),
            "start_value": np.asarray(p["start_value"], dtype=np.uint8),
            "final_xor": np.asarray(p["final_xor"], dtype=np.uint8),
            "lsb_first": bool(p.get("ref_in", False)),
            "reverse_polynomial": bool(p.get("reverse_polynomial", False)),
            "reverse_all": bool(p.get("ref_out", False)),
            "little_endian": bool(p.get("little_endian", False)),
        })
    return configs


# shared with the scalar engine (coding/crc.py)
_column_order = bit_column_order


def _finalize_vec(state: np.ndarray, width: int, final_xor_int: int,
                  reverse_all: bool, little_endian: bool) -> np.ndarray:
    """Vectorized final-xor / reflect / little-endian post transform."""
    out = state ^ final_xor_int
    if reverse_all:
        r = np.zeros_like(out)
        for b in range(width):
            r |= ((out >> b) & 1) << (width - 1 - b)
        out = r
    if little_endian:
        # standard configs never set this; keep a correct scalar fallback
        out = np.array([_little_endian_swap(int(v), width) for v in out],
                       dtype=np.int64)
    return out


def _steps_table(cfg, data_end: int, width: int, crc_mask: int, poly_int: int,
                 final_xor_int: int) -> list:
    """Impulse-delta table steps[idx] (message-independent), faithful to
    coding/crc.get_crc_datarange:130-173 including the reference's
    reverse_all steps[width] overwrite quirk."""
    steps = [0] * (data_end + width + 2)
    poly_mask = (crc_mask + 1) >> 1
    crcv = bits_to_int(cfg["start_value"]) & crc_mask
    for idx in _column_order(data_end, cfg["lsb_first"]):
        bit = idx == 0
        if ((crcv & poly_mask) > 0) != bit:
            crcv = ((crcv << 1) & crc_mask) ^ poly_int
        else:
            crcv = (crcv << 1) & crc_mask
        steps[idx] = crcv ^ final_xor_int

    reverse_all, little_endian = cfg["reverse_all"], cfg["little_endian"]
    if reverse_all and little_endian:
        for i in range(data_end):
            temp = _reflect(steps[i], width)
            steps[width] = temp & crc_mask
            steps[i] = _little_endian_swap(steps[i], width)
    elif reverse_all:
        if data_end > 0:
            last = steps[data_end - 1]
            if data_end - 1 == width and data_end > 1:
                last = _reflect(steps[data_end - 2], width) & crc_mask
            steps[width] = _reflect(last, width) & crc_mask
    elif little_endian:
        steps[:data_end] = [_little_endian_swap(s, width)
                            for s in steps[:data_end]]
    return steps


def _evolve_states(bits: np.ndarray, order: list, poly_int: int,
                   crc_mask: int, start_int: int, snapshots: set) -> dict:
    """Run the CRC state recurrence over bit columns in ``order`` for all
    B messages at once; return {prefix_count: state_vector}."""
    poly_mask = (crc_mask + 1) >> 1
    state = np.full(bits.shape[0], start_int, dtype=np.int64)
    out = {}
    if 0 in snapshots:
        out[0] = state.copy()
    for k, idx in enumerate(order):
        msb = (state & poly_mask) > 0
        xor_needed = msb != (bits[:, idx] > 0)
        state = ((state << 1) & crc_mask) ^ np.where(xor_needed, poly_int, 0)
        if k + 1 in snapshots:
            out[k + 1] = state.copy()
    return out


def batched_guess_all(bitvectors, indices, trash_max: int = 7,
                      ignore_positions: set = None) -> dict:
    """guess_all for every message in ``indices`` at once.

    Returns {index: (GenericCRC, data_start, data_end, crc_start,
    crc_end)} containing only the messages with a hit; results match
    GenericCRC.guess_all message-for-message.
    """
    ignore_positions = ignore_positions or set()
    configs = _configs_in_priority_order()
    results = {}

    by_len = {}
    for index in indices:
        by_len.setdefault(len(bitvectors[index]), []).append(index)

    for L, members in by_len.items():
        bits = np.zeros((len(members), L), dtype=np.uint8)
        for row, index in enumerate(members):
            bits[row] = np.asarray(bitvectors[index], dtype=np.uint8)

        # hit[t][c] = (ds_vector or None); ds == -1 -> no hit for that row
        hits = [[None] * len(configs) for _ in range(trash_max)]

        for c, cfg in enumerate(configs):
            poly_order = len(cfg["polynomial"])
            width = poly_order - 1
            crc_mask = (1 << width) - 1
            poly_int = bits_to_int(cfg["polynomial"],
                                   cfg["reverse_polynomial"], 1) & crc_mask
            final_xor_int = bits_to_int(cfg["final_xor"]) & crc_mask
            start_int = bits_to_int(cfg["start_value"]) & crc_mask

            trash_de = {}
            for t in range(trash_max):
                de = max(0, L - t - poly_order) + 1
                if de - 1 + width >= L or de < 2:
                    continue
                trash_de[t] = de
            if not trash_de:
                continue

            de_max = max(trash_de.values())
            order = _column_order(de_max, cfg["lsb_first"])
            prefix_counts = {de: len(_column_order(de, cfg["lsb_first"]))
                             for de in trash_de.values()}
            states = _evolve_states(bits, order, poly_int, crc_mask,
                                    start_int, set(prefix_counts.values()))

            weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)

            for t, de in trash_de.items():
                crc_full = _finalize_vec(states[prefix_counts[de]], width,
                                         final_xor_int, cfg["reverse_all"],
                                         cfg["little_endian"])
                vrfy = bits[:, de:de + width].astype(np.int64) @ weights

                steps = _steps_table(cfg, de, width, crc_mask, poly_int,
                                     final_xor_int)
                # steps_sel[p] = steps[de - p - 1] -- the delta XORed when
                # the scan lands on position p
                steps_sel = np.asarray(
                    [steps[de - p - 1] for p in range(de)], dtype=np.int64)

                # landing positions: one-bits before de-1, plus de-1 always
                part = bits[:, :de] > 0
                part[:, de - 1] = True
                contrib = np.where(part, steps_sel[None, :], 0)
                cum = crc_full[:, None] ^ np.bitwise_xor.accumulate(contrib,
                                                                    axis=1)

                # a match at landing p yields data_start p+1 only if the
                # NEXT scan iteration runs (i = p+1 < de-1); matches on the
                # last landings are dropped, like the reference
                match = part & (cum == vrfy[:, None])
                match[:, max(0, de - 2):] = False
                any_match = match.any(axis=1)
                first_p = match.argmax(axis=1)

                ds = np.where(any_match, first_p + 1, -1).astype(np.int64)
                # whole-range match wins before the scan starts
                ds = np.where(crc_full == vrfy, 0, ds)
                hits[t][c] = ds if (ds >= 0).any() else None

        # per-message resolution in guess_all's priority order: trash
        # ascending; within a trash the first config hit decides, and an
        # ignore-overlap of ITS crc range skips the whole trash level
        remaining = np.arange(len(members))
        for t in range(trash_max):
            if len(remaining) == 0:
                break
            taken = np.zeros(len(members), dtype=bool)
            for c, cfg in enumerate(configs):
                ds_vec = hits[t][c]
                if ds_vec is None:
                    continue
                poly_order = len(cfg["polynomial"])
                crc_start = L - t - poly_order + 1
                crc_end = L - t
                ignored = any(p in ignore_positions
                              for p in range(crc_start, crc_end))
                for row in remaining:
                    if taken[row] or ds_vec[row] < 0:
                        continue
                    taken[row] = True  # first config hit decides this trash
                    if ignored:
                        continue  # skip the trash level for this message
                    de = max(0, L - t - poly_order) + 1
                    crc_obj = GenericCRC()
                    crc_obj.set_individual_parameters(
                        polynomial=_to_arr(cfg["polynomial"]),
                        start_value=_to_arr(cfg["start_value"]),
                        final_xor=_to_arr(cfg["final_xor"]),
                        ref_in=cfg["lsb_first"],
                        ref_out=cfg["reverse_all"],
                        little_endian=cfg["little_endian"],
                        reverse_polynomial=cfg["reverse_polynomial"])
                    crc_obj.caption = cfg["name"]
                    results[members[row]] = (crc_obj, int(ds_vec[row]), de,
                                             crc_start, crc_end)
            remaining = np.asarray([row for row in remaining
                                    if members[row] not in results])
    return results


def _to_arr(a: np.ndarray):
    import array

    return array.array("B", a.tolist())
