"""PCAPNG export (urh/dev/PCAPNG.py counterpart).

Writes Section Header Block + Interface Description Block + Enhanced
Packet Blocks per the IETF pcapng draft, big-endian, link type 147
(DLT_USER0) by default.
"""

from __future__ import annotations

import math
import os
import struct


def _pad32(n: int) -> int:
    return math.ceil(n / 4) * 4


def _build_shb(shb_userappl: str = "", shb_hardware: str = "") -> bytes:
    BLOCKTYPE = 0x0A0D0D0A
    HEADERS_BLOCK_LENGTH = 28
    MAGIC_NUMBER = 0x1A2B3C4D
    SECTIONLENGTH = 0xFFFFFFFFFFFFFFFF  # unspecified

    userappl_padded = _pad32(len(shb_userappl))
    hardware_padded = _pad32(len(shb_hardware))

    total = HEADERS_BLOCK_LENGTH
    if userappl_padded > 0:
        total += userappl_padded + 4
    if hardware_padded > 0:
        total += hardware_padded + 4

    shb = struct.pack(">IIIHHQ", BLOCKTYPE, total, MAGIC_NUMBER, 1, 0, SECTIONLENGTH)
    if shb_userappl:
        shb += struct.pack(">HH", 4, userappl_padded)
        shb += shb_userappl.ljust(userappl_padded, "\0").encode("ascii")
    if shb_hardware:
        shb += struct.pack(">HH", 2, hardware_padded)
        shb += shb_hardware.ljust(hardware_padded, "\0").encode("ascii")
    shb += struct.pack(">I", total)
    return shb


def _build_idb(link_type: int) -> bytes:
    return struct.pack(">IIHHII", 0x00000001, 20, link_type, 0, 0, 20)


def _build_epb(packet: bytes, timestamp: float) -> bytes:
    BLOCKHEADERLEN = 32
    captured = len(packet)
    padded = _pad32(captured)
    block_total = BLOCKHEADERLEN + padded
    ts = int(timestamp * 1e6)
    epb = struct.pack(">IIIIIII", 0x00000006, block_total, 0,
                      ts >> 32, ts & 0xFFFFFFFF, captured, captured)
    epb += bytes(packet) + bytes(padded - captured)
    epb += struct.pack(">I", block_total)
    return epb


def create_pcapng_file(filename: str, shb_userappl: str = "", shb_hardware: str = "",
                       link_type: int = 147):
    if filename == "":
        return
    with open(filename, "wb") as f:
        f.write(_build_shb(shb_userappl, shb_hardware))
        f.write(_build_idb(link_type))


def append_packets_to_pcapng(filename: str, packets, timestamps):
    with open(filename, "ab") as f:
        for packet, timestamp in zip(packets, timestamps):
            f.write(_build_epb(packet, timestamp))
