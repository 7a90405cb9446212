"""Participant auto assignment by address and RSSI clustering
(urh/awre/AutoAssigner.py)."""

from __future__ import annotations

import numpy as np


def _assign_by_source_address(messages, participants):
    by_address = {p.address_hex: p for p in participants if p.address_hex}
    for msg in messages:
        if msg.participant is not None:
            continue
        src_address = msg.get_src_address_from_data()
        if src_address and src_address in by_address:
            msg.participant = by_address[src_address]


def auto_assign_participants(messages, participants):
    n_participants = len(participants)
    if n_participants == 0:
        return
    if n_participants == 1:
        for message in messages:
            message.participant = participants[0]
        return

    _assign_by_source_address(messages, participants)

    # remaining messages: nearest of evenly spaced RSSI centers between the
    # observed min and max, participants ordered by relative RSSI
    rssis = np.array([msg.rssi for msg in messages], dtype=np.float32)
    if rssis.size == 0:
        return
    lo, hi = float(rssis.min()), float(rssis.max())
    centers = np.linspace(lo, hi, n_participants, dtype=np.float64)
    nearest = np.argmin(np.abs(rssis[:, None] - centers[None, :]), axis=1)

    ranked = sorted(participants, key=lambda participant: participant.relative_rssi)
    participants[:] = ranked
    for message, center_index in zip(messages, nearest):
        if message.participant is None:
            message.participant = ranked[int(center_index)]


def auto_assign_participant_addresses(messages, participants):
    pending = {id(p): p for p in participants if not p.address_hex}
    if not pending:
        return
    for msg in messages:
        if msg.participant is None or id(msg.participant) not in pending:
            continue
        src_address = msg.get_src_address_from_data()
        if src_address:
            del pending[id(msg.participant)]
            msg.participant.address_hex = src_address
