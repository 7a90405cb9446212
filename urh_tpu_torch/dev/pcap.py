"""Classic PCAP export (host copy of urh_tpu.dev.pcap, the urh/dev/PCAP.py
counterpart).

Same wire format — nanosecond-magic global header, link type 147
(LINKTYPE_USER0), one record per message — but built on a single
integer-nanosecond clock instead of separate (sec, nsec) counters.
"""

from __future__ import annotations

import struct
import time

_GLOBAL_HEADER = struct.Struct(">IHHiIII")
_RECORD_HEADER = struct.Struct(">IIII")

NANOS_PER_SEC = 10 ** 9
NANO_MAGIC = 0xA1B23C4D   # timestamps carry nanoseconds, not microseconds
LINKTYPE_USER0 = 147
SNAP_LENGTH = 0xFFFF


def global_header() -> bytes:
    return _GLOBAL_HEADER.pack(NANO_MAGIC, 2, 4, 0, 0, SNAP_LENGTH,
                               LINKTYPE_USER0)


def record(clock_ns: int, payload: bytes) -> bytes:
    sec, nsec = divmod(int(clock_ns), NANOS_PER_SEC)
    return _RECORD_HEADER.pack(sec, nsec, len(payload), len(payload)) + payload


class PCAP:
    def __init__(self):
        self._clock_ns = None

    def reset_timestamp(self):
        self._clock_ns = None

    def build_global_header(self) -> bytes:
        self.reset_timestamp()
        return global_header()

    def build_packet(self, ts_sec: int, ts_nsec: int, data: bytes) -> bytes:
        """Advance the capture clock by the given delta and emit one
        record at the resulting instant (first call anchors at now)."""
        if self._clock_ns is None:
            self._clock_ns = int(time.time() * NANOS_PER_SEC)
        self._clock_ns += int(ts_sec) * NANOS_PER_SEC + int(ts_nsec)
        return record(self._clock_ns, data)

    def write_packets(self, packets, filename: str, sample_rate: int):
        """Messages -> one capture file; each record is spaced by the
        previous message's on-air duration."""
        with open(filename, "wb") as f:
            f.write(self.build_global_header())
            gap_ns = 0
            for packet in packets:
                f.write(self.build_packet(0, gap_ns,
                                          packet.decoded_bits_buffer))
                gap_ns = packet.get_duration(sample_rate) * NANOS_PER_SEC

    @staticmethod
    def get_seconds_nseconds(timestamp):
        nanos = int(timestamp * NANOS_PER_SEC)
        return divmod(nanos, NANOS_PER_SEC)
