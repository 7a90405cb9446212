"""rtl_tcp client device: talk to an osmocom ``rtl_tcp`` server over TCP,
no vendor library needed (role of urh/dev/native/RTLSDRTCP.py).

Layered very differently from the reference's monolithic device class:

* :data:`PARAMETERS` — one declarative registry row per tunable.  Table
  order IS the startup programming order (the tuner gain row sits last
  because earlier writes reset the gain on real dongles), and the same
  rows drive runtime Command dispatch, so the two can never disagree.
* codec functions — the 5-byte command encoding and the 12-byte
  greeting parse are pure functions, unit-testable without a socket.
* :class:`RtlTcpLink` — owns the TCP socket: connect, greet, program,
  stream.  Knows nothing about urh_tpu_torch's device process machinery.
* :class:`RTLSDRTCP` — thin :class:`Device` adapter that runs a link
  inside the standard receive subprocess.

Wire protocol (fixed by the rtl_tcp server, all big-endian): greeting
``b"RTL0" | u32 tuner_type | u32 tuner_gain_count``; each command is
``u8 opcode | u32 value``.
"""

from __future__ import annotations

import select
import socket
from dataclasses import dataclass

import numpy as np

from urh_tpu_torch.dev.device import Device
from urh_tpu_torch.util.logging import logger

MAGIC = b"RTL0"
GREETING_LEN = 12
READ_CHUNK = 65536

TUNER_TYPES = ("Unknown", "E4000", "FC0012", "FC0013", "FC2580", "R820T",
               "R828D")


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def encode_command(opcode: int, value: int) -> bytes:
    """u8 opcode | u32 value, big-endian."""
    return bytes([opcode & 0xFF]) + (int(value) & 0xFFFFFFFF).to_bytes(4, "big")


def parse_greeting(blob: bytes):
    """12-byte server hello -> dict, or None if this isn't rtl_tcp."""
    if len(blob) != GREETING_LEN or not blob.startswith(MAGIC):
        return None
    tuner_type = int.from_bytes(blob[4:8], "big")
    return {
        "tuner": TUNER_TYPES[tuner_type] if tuner_type < len(TUNER_TYPES)
        else "Unknown",
        "gain_count": int.from_bytes(blob[8:12], "big"),
    }


# ---------------------------------------------------------------------------
# parameter registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Parameter:
    name: str          # rtl_tcp parameter name
    opcode: int        # wire opcode
    command: str = ""  # Device.Command name served at runtime ("" = none)
    startup: str = ""  # attribute of the startup config programmed at open


# Table order is programming order; tunerGain LAST on purpose.
PARAMETERS = (
    Parameter("centerFreq", 0x01, "SET_FREQUENCY", "frequency"),
    Parameter("sampleRate", 0x02, "SET_SAMPLE_RATE", "sample_rate"),
    Parameter("tunerGainMode", 0x03),
    Parameter("freqCorrection", 0x05, "SET_FREQUENCY_CORRECTION",
              "freq_correction"),
    Parameter("tunerIFGain", 0x06, "SET_IF_GAIN"),
    Parameter("testMode", 0x07),
    Parameter("agcMode", 0x08),
    Parameter("directSampling", 0x09, "SET_DIRECT_SAMPLING_MODE",
              "direct_sampling_mode"),
    Parameter("offsetTuning", 0x0A),
    Parameter("rtlXtalFreq", 0x0B),
    Parameter("tunerXtalFreq", 0x0C),
    Parameter("gainByIndex", 0x0D),
    Parameter("biasTee", 0x0E, "SET_BIAS_TEE_ENABLED", "bias_tee_enabled"),
    # pinkavaj/rtl-sdr extension; the osmocom server ignores it
    Parameter("bandwidth", 0x40, "SET_BANDWIDTH", "bandwidth"),
    Parameter("tunerGain", 0x04, "SET_RF_GAIN", "gain"),
)

_BY_NAME = {p.name: p for p in PARAMETERS}
_BY_COMMAND = {p.command: p for p in PARAMETERS if p.command}


# ---------------------------------------------------------------------------
# socket link
# ---------------------------------------------------------------------------


class RtlTcpLink:
    """One TCP connection to an rtl_tcp server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1234):
        self.host, self.port = host, port
        self.sock = None
        self.greeting = None

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def connect(self) -> dict:
        """Open the socket and validate the greeting.

        Returns the parsed greeting; raises ConnectionError on refusal
        or a non-rtl_tcp peer.
        """
        sock = socket.create_connection((self.host, self.port), timeout=5)
        hello = b""
        while len(hello) < GREETING_LEN:
            chunk = sock.recv(GREETING_LEN - len(hello))
            if not chunk:
                break
            hello += chunk
        greeting = parse_greeting(hello)
        if greeting is None:
            sock.close()
            raise ConnectionError(
                f"{self.host}:{self.port} is not an rtl_tcp server")
        sock.settimeout(None)
        self.sock, self.greeting = sock, greeting
        return greeting

    def set(self, name: str, value: int) -> None:
        self.sock.sendall(encode_command(_BY_NAME[name].opcode, value))

    def program(self, config: dict) -> None:
        """Apply a startup config in registry order."""
        for p in PARAMETERS:
            if p.startup and p.startup in config:
                self.set(p.name, int(config[p.startup]))

    def read(self, timeout: float = 0.1) -> bytes:
        ready, _, _ = select.select([self.sock], [], [], timeout)
        return self.sock.recv(READ_CHUNK) if ready else b""

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None


# ---------------------------------------------------------------------------
# Device adapter
# ---------------------------------------------------------------------------


class RTLSDRTCP(Device):
    DATA_TYPE = np.int8

    def __init__(self, freq, gain, srate, bandwidth, device_number,
                 resume_on_full_receive_buffer=False):
        super().__init__(center_freq=freq, sample_rate=srate,
                         bandwidth=bandwidth, gain=gain, if_gain=1,
                         baseband_gain=1,
                         resume_on_full_receive_buffer=resume_on_full_receive_buffer)
        self.receive_process_function = self.receive_sync
        self.device_number = device_number
        self.device_ip = "127.0.0.1"  # rtl_tcp default; overridable via config
        self.port = 1234

    @property
    def receive_process_arguments(self):
        config = {
            "frequency": self.frequency,
            "sample_rate": self.sample_rate,
            "bandwidth": self.bandwidth,
            "gain": self.gain,
            "freq_correction": self.freq_correction,
            "direct_sampling_mode": self.direct_sampling_mode,
            "bias_tee_enabled": int(self.bias_tee_enabled),
        }
        return (self.child_data_conn, self.child_ctrl_conn, config,
                self.device_ip, self.port)

    @staticmethod
    def receive_sync(data_connection, ctrl_connection, config, host, port):
        """Receive-subprocess entry: link lifecycle + command pump."""
        link = RtlTcpLink(host, port)
        try:
            greeting = link.connect()
        except (OSError, ConnectionError) as e:
            ctrl_connection.send(f"Could not connect to rtl_tcp at "
                                 f"{host}:{port} ({e}):1")
            ctrl_connection.send("close:0")
            data_connection.close()
            ctrl_connection.close()
            return

        ctrl_connection.send(
            "Connected to rtl_tcp at {}:{} (Tuner={}, Gains={}):0".format(
                host, port, greeting["tuner"], greeting["gain_count"]))
        link.program(config)

        running = True
        while running:
            while ctrl_connection.poll():
                if RTLSDRTCP._dispatch(link, ctrl_connection.recv(),
                                       ctrl_connection) is Device.Command.STOP:
                    running = False
                    break
            if running:
                data_connection.send_bytes(link.read())

        link.close()
        ctrl_connection.send("close:0")
        data_connection.close()
        ctrl_connection.close()

    @staticmethod
    def _dispatch(link: RtlTcpLink, message, ctrl_connection):
        """One control message -> registry lookup -> wire command."""
        if message == Device.Command.STOP.name:
            return Device.Command.STOP
        tag, value = message
        param = _BY_COMMAND.get(tag)
        if param is None:
            logger.warning("rtl_tcp: unsupported command %s", tag)
            return None
        try:
            link.set(param.name, int(value))
        except OSError as e:
            ctrl_connection.send(
                f"Could not set parameter {param.name} {value} ({e}):1")
        return None

    @staticmethod
    def bytes_to_iq(buffer):
        """rtl_tcp streams unsigned 8-bit IQ; center at 128 so the full
        0..255 range maps onto int8 without overflow."""
        u = np.frombuffer(buffer, dtype=np.uint8)
        u = u[: len(u) & ~1]  # TCP chunks may split an IQ pair
        return (u.astype(np.int16) - 128).astype(np.int8).reshape((-1, 2))
