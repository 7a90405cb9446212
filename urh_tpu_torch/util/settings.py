"""The user's settings store (the part of urh_tpu.util.settings that the
port needs).

The store is urh_tpu's JSON file, ``$XDG_CONFIG_HOME/urh_tpu/settings.json``
(``~/.config`` without XDG_CONFIG_HOME), so a setting made for urh_tpu, such
as ``modulation_dtype``, holds for the port too, and one the port writes
holds for urh_tpu.  :func:`write` replaces the file atomically (a
temporary file in the same directory, then ``os.replace``), as urh_tpu's
does.  The constants, the receive-buffer policy and the decoding chain
names are urh_tpu's (``urh_tpu/util/settings.py``).  ``config_dir()`` also
holds the user's ``decodings.txt``, which ``util/project.py`` reads and
writes, and placement's ``placement_verdicts.json``: neither is the store.
"""

from __future__ import annotations

import json
import os
import tempfile

PIXELS_PER_PATH = 5000  # urh_tpu.util.settings: min/max pairs of a plot path
SPECTRUM_BUFFER_SIZE = 2 ** 15
SNIFF_BUFFER_SIZE = 5 * 10 ** 7
CONTINUOUS_BUFFER_SIZE_MB = 50

_config_dir = os.path.join(
    os.environ.get("XDG_CONFIG_HOME", os.path.join(os.path.expanduser("~"), ".config")),
    "urh_tpu",
)
_settings_file = os.path.join(_config_dir, "settings.json")

_store = None
OVERWRITE_RECEIVE_BUFFER_SIZE = None  # for tests


def config_dir() -> str:
    return _config_dir


def _load() -> dict:
    global _store
    if _store is None:
        try:
            with open(_settings_file) as f:
                _store = json.load(f)
        except (OSError, ValueError):
            _store = {}
    return _store


def read(key, default_value=None, type=str):
    value = _load().get(key, default_value)
    if value is None:
        return None
    try:
        if type is bool:
            return value in (True, "true", "True", 1, "1")
        return type(value)
    except (TypeError, ValueError):
        return default_value


def write(key, value):
    store = _load()
    store[key] = value
    try:
        os.makedirs(_config_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_config_dir)
        with os.fdopen(fd, "w") as f:
            json.dump(store, f, indent=1)
        os.replace(tmp, _settings_file)
    except OSError:  # a read-only config dir keeps the value in this process
        pass


def all_keys():
    return list(_load().keys())


def sync():
    """Nothing to flush: every write already replaced the file."""


def get_receive_buffer_size(resume_on_full_receive_buffer: bool, spectrum_mode: bool) -> int:
    """Receive-buffer sizing policy (settings.py:184-213 in the reference)."""
    if OVERWRITE_RECEIVE_BUFFER_SIZE:
        return OVERWRITE_RECEIVE_BUFFER_SIZE
    if resume_on_full_receive_buffer:
        return SPECTRUM_BUFFER_SIZE if spectrum_mode else SNIFF_BUFFER_SIZE
    # unlimited-ish: bounded by a RAM-threshold heuristic
    num_samples = SNIFF_BUFFER_SIZE
    try:
        import psutil

        threshold = read("ram_threshold", 0.6, float)
        available = threshold * psutil.virtual_memory().available
        num_samples = int(available / 8)
    except ImportError:
        pass
    return min(num_samples, 10 ** 9)


# -- decoding chain name constants (settings.py:89-102 in the reference) --
DECODING_INVERT = "Invert"
DECODING_DIFFERENTIAL = "Differential Encoding"
DECODING_REDUNDANCY = "Remove Redundancy"
DECODING_DATAWHITENING = "Remove Data Whitening (CC1101)"
DECODING_CARRIER = "Remove Carrier"
DECODING_BITORDER = "Change Bitorder"
DECODING_EDGE = "Edge Trigger"
DECODING_SUBSTITUTION = "Substitution"
DECODING_EXTERNAL = "External Program"
DECODING_ENOCEAN = "Wireless Short Packet (WSP)"
DECODING_CUT = "Cut before/after"
DECODING_MORSE = "Morse Code"
DECODING_DISABLED_PREFIX = "[Disabled] "
