"""Device parameter defaults and per-device capability ranges
(counterpart of urh/dev/config.py)."""

from __future__ import annotations

from collections import OrderedDict, namedtuple

DEFAULT_FREQUENCY = 433.92e6
DEFAULT_SAMPLE_RATE = 1e6
DEFAULT_BANDWIDTH = 1e6
DEFAULT_GAIN = 20
DEFAULT_IF_GAIN = 20
DEFAULT_BB_GAIN = 16
DEFAULT_FREQ_CORRECTION = 1
DEFAULT_DIRECT_SAMPLING_MODE = 0

dev_range = namedtuple("dev_range", ["start", "stop", "step"])

K = 10 ** 3
M = 10 ** 6
G = 10 ** 9

DEVICE_CONFIG = OrderedDict()

DEVICE_CONFIG["HackRF"] = {
    "center_freq": dev_range(start=10, stop=6 * G, step=1),
    "sample_rate": dev_range(start=2 * M, stop=20 * M, step=1),
    "bandwidth": [1.75 * M, 2.5 * M, 3.5 * M, 5 * M, 5.5 * M, 6 * M, 7 * M,
                  8 * M, 9 * M, 10 * M, 12 * M, 14 * M, 15 * M, 20 * M, 24 * M, 28 * M],
    "rx_rf_gain": [0, 14],
    "tx_rf_gain": [0, 14],
    "rx_if_gain": list(range(0, 41, 8)),
    "tx_if_gain": list(range(0, 48)),
    "rx_baseband_gain": list(range(0, 63, 2)),
}

DEVICE_CONFIG["RTL-SDR"] = {
    "center_freq": dev_range(start=22 * M, stop=2200 * M, step=1),
    "sample_rate": dev_range(start=1, stop=3200 * K, step=1),
    "bandwidth": dev_range(start=1, stop=3200 * K, step=1),
    "rx_rf_gain": [0.0, 0.9, 1.4, 2.7, 3.7, 7.7, 8.7, 12.5, 14.4, 15.7, 16.6,
                   19.7, 20.7, 22.9, 25.4, 28.0, 29.7, 32.8, 33.8, 36.4, 37.2,
                   38.6, 40.2, 42.1, 43.4, 43.9, 44.5, 48.0, 49.6],
    "direct_sampling": ["disabled", "I-ADC input enabled", "Q-ADC input enabled"],
    "freq_correction": dev_range(start=-1 * 10 ** 3, stop=1 * 10 ** 3, step=1),
}

DEVICE_CONFIG["USRP"] = {
    "center_freq": dev_range(start=0, stop=6 * G, step=1),
    "sample_rate": dev_range(start=1, stop=200 * M, step=1),
    "bandwidth": dev_range(start=1, stop=120 * M, step=1),
    "device_args": "",
    "ip": "",
    "rx_rf_gain": dev_range(start=0, stop=100, step=1),
    "tx_rf_gain": dev_range(start=0, stop=100, step=1),
    "antenna": [0, 1],
}

DEVICE_CONFIG["LimeSDR"] = {
    "center_freq": dev_range(start=100 * K, stop=3800 * M, step=1),
    "sample_rate": dev_range(start=100 * K, stop=61.44 * M, step=1),
    "bandwidth": dev_range(start=1.25 * M, stop=120 * M, step=1),
    "rx_rf_gain": dev_range(start=0, stop=70, step=1),
    "tx_rf_gain": dev_range(start=0, stop=70, step=1),
    "rx_antenna": ["None", "High (RX_H)", "Low (RX_L)", "Wide (RX_W)"],
    "tx_antenna": ["None", "Band 1 (TX_1)", "Band 2 (TX_2)"],
}

DEVICE_CONFIG["AirSpy R2"] = {
    "center_freq": dev_range(start=24 * M, stop=1800 * M, step=1),
    "sample_rate": [2.5 * M, 10 * M],
    "bandwidth": [2.5 * M, 10 * M],
    "rx_rf_gain": dev_range(start=0, stop=15, step=1),
    "rx_if_gain": dev_range(start=0, stop=15, step=1),
    "rx_baseband_gain": dev_range(start=0, stop=15, step=1),
}

DEVICE_CONFIG["BladeRF"] = {
    "center_freq": dev_range(start=47 * M, stop=6 * G, step=1),
    "sample_rate": dev_range(start=520834, stop=61.44 * M, step=1),
    "bandwidth": dev_range(start=1.5 * M, stop=28 * M, step=1),
    "rx_rf_gain": dev_range(start=-15, stop=60, step=1),
    "tx_rf_gain": dev_range(start=-35, stop=25, step=1),
    "bias_tee_enabled": [False, True],
}

DEVICE_CONFIG["PlutoSDR"] = {
    "center_freq": dev_range(start=70 * M, stop=6 * G, step=1),
    "sample_rate": dev_range(start=2.1 * M, stop=61.44 * M, step=1),
    "bandwidth": dev_range(start=0.2 * M, stop=56 * M, step=1),
    "tx_rf_gain": list(range(-89, 1)),
    "rx_rf_gain": list(range(-3, 72)),
}

DEVICE_CONFIG["SDRPlay"] = {
    "center_freq": dev_range(start=1 * K, stop=2 * G, step=1),
    "sample_rate": dev_range(start=2 * M, stop=10 * M, step=1),
    "bandwidth": [0.2 * M, 0.3 * M, 0.6 * M, 1.536 * M, 5 * M, 6 * M, 7 * M, 8 * M],
    "rx_rf_gain": dev_range(start=20, stop=59, step=1),
    "antenna": ["A", "B"],
}

DEVICE_CONFIG["SoundCard"] = {
    "sample_rate": [44100, 48000, 96000, 192000],
}

DEVICE_CONFIG["Network SDR"] = {}

DEVICE_CONFIG["Fallback"] = {
    "center_freq": dev_range(start=1 * M, stop=6 * G, step=1),
    "sample_rate": dev_range(start=2 * M, stop=20 * M, step=1),
    "bandwidth": dev_range(start=2 * M, stop=20 * M, step=1),
    "rx_rf_gain": dev_range(start=0, stop=100, step=1),
    "tx_rf_gain": dev_range(start=0, stop=100, step=1),
}
