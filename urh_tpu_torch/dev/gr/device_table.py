"""Device table for the GNU Radio backend.

One row per SDR reachable through gr-osmosdr, replacing the reference's
hand-maintained per-device flowgraph pairs
(urh/dev/gr/scripts/{hackrf,usrp,...}_{recv,send}.py, themselves built
by urh/dev/gr/scripts/__create_gr_script.py).  The per-device scripts in
``scripts/`` are *generated* from this table by :mod:`generate_scripts`;
edit the table, not the scripts.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class GRDevice:
    name: str                    # display name as used by VirtualDevice
    osmosdr_args: str            # device selector for osmosdr.source/sink
    directions: tuple = ("recv",)
    has_if_gain: bool = True     # IF gain stage exists (osmosdr no-ops otherwise)
    has_bb_gain: bool = True
    has_bandwidth: bool = True
    has_direct_sampling: bool = False  # RTL-SDR direct sampling mode
    antennas: tuple = ()         # selectable antennas (index -> name)

    @property
    def script_stem(self) -> str:
        return self.name.lower().replace(" ", "").replace("-", "")


# gr-osmosdr argument strings: see the osmosdr device ids used by the
# reference scripts (hackrf_recv.py:36, usrp_recv.py:37, rtl-sdr_recv.py)
GR_DEVICES = (
    GRDevice("AirSpy", "airspy"),
    GRDevice("BladeRF", "bladerf=0", directions=("recv", "send")),
    GRDevice("FUNcube", "fcd=0", has_if_gain=False, has_bb_gain=False,
             has_bandwidth=False),
    GRDevice("HackRF", "hackrf", directions=("recv", "send")),
    GRDevice("RTL-SDR", "rtl=0", has_direct_sampling=True),
    GRDevice("SDRPlay", "sdrplay"),
    GRDevice("USRP", "uhd", directions=("recv", "send"),
             antennas=("TX/RX", "RX2")),
)


def devices_by_stem() -> dict:
    return {d.script_stem: d for d in GR_DEVICES}
