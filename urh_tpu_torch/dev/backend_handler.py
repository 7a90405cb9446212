"""Backend discovery per device (counterpart of urh/dev/BackendHandler.py).

Probes which device backends are importable/available.  In this build
the native SDR vendor libraries are optional host dependencies; the
Network SDR (TCP) backend is always available and doubles as the test
device.  A backend's choice and enabled flag are read from and written to
the settings store (urh_tpu's file, urh_tpu's keys).
"""

from __future__ import annotations

import importlib
from enum import Enum

from urh_tpu_torch.util import settings


class Backends(Enum):
    none = "none"
    native = "native"
    grc = "Gnuradio"
    network = "network"


class BackendContainer:
    def __init__(self, name, avail_backends: set, supports_rx: bool, supports_tx: bool):
        self.name = name
        self.avail_backends = avail_backends
        stored = settings.read(name + "_selected_backend", "", str)
        try:
            self.selected_backend = Backends[stored]
        except KeyError:
            self.selected_backend = Backends.none
        if self.selected_backend not in self.avail_backends:
            if Backends.native in self.avail_backends:
                self.selected_backend = Backends.native
            elif Backends.grc in self.avail_backends:
                self.selected_backend = Backends.grc
            else:
                self.selected_backend = Backends.none
        self.supports_rx = supports_rx
        self.supports_tx = supports_tx

    @property
    def is_enabled(self):
        return settings.read(self.name + "_is_enabled", True, bool)

    @property
    def has_native_backend(self):
        return Backends.native in self.avail_backends

    @property
    def has_gnuradio_backend(self):
        return Backends.grc in self.avail_backends

    def set_enabled(self, enabled: bool):
        settings.write(self.name + "_is_enabled", enabled)

    def write_settings(self):
        settings.write(self.name + "_selected_backend", self.selected_backend.name)

    def __repr__(self):
        return "avail backends: {0} | selected backend: {1}".format(
            self.avail_backends, self.selected_backend)


class BackendHandler:
    """Probe importability of native SDR bindings and build the device map."""

    DEVICE_NAMES = ("AirSpy R2", "AirSpy Mini", "BladeRF", "FUNcube", "HackRF",
                    "LimeSDR", "PlutoSDR", "RTL-SDR", "RTL-TCP", "SDRPlay",
                    "SoundCard", "USRP")

    # python modules that would provide each native binding
    DEVICE_MODULES = {
        "airspy r2": "airspy", "airspy mini": "airspy", "bladerf": "bladerf",
        "funcube": "hid", "hackrf": "hackrf", "limesdr": "limesdr",
        "plutosdr": "plutosdr", "rtl-sdr": "rtlsdr", "sdrplay": "sdrplay",
        "soundcard": "pyaudio", "usrp": "usrp",
    }

    # devices implemented purely in python on top of sockets
    PURE_PYTHON_DEVICES = {"rtl-tcp"}

    def __init__(self, testing_mode=False):
        self.testing_mode = testing_mode
        self.device_backends = {}
        self.get_backends()

    @property
    def num_native_backends(self):
        return len([dev for dev, backend_container in self.device_backends.items()
                    if Backends.native in backend_container.avail_backends
                    and dev.lower() != "rtl-tcp"])

    # shared C library names probed for each device binding
    DEVICE_C_LIBS = {
        "airspy r2": ("airspy",), "airspy mini": ("airspy",),
        "bladerf": ("bladeRF",), "hackrf": ("hackrf",),
        "limesdr": ("LimeSuite",), "plutosdr": ("iio",),
        "rtl-sdr": ("rtlsdr",), "sdrplay": ("sdrplay_api", "mirsdrapi-rsp"),
        "usrp": ("uhd",),
    }

    def _avail_backends_for_device(self, devname: str) -> set:
        import ctypes.util

        backends = set()
        if self.testing_mode:
            backends.add(Backends.native)
            return backends
        if devname in self.PURE_PYTHON_DEVICES:
            backends.add(Backends.native)
            return backends
        for libname in self.DEVICE_C_LIBS.get(devname, ()):
            if ctypes.util.find_library(libname):
                backends.add(Backends.native)
                return backends
        module = self.DEVICE_MODULES.get(devname)
        if module is not None:
            try:
                importlib.import_module(module)
                backends.add(Backends.native)
            except ImportError:
                pass
        return backends

    def get_backends(self):
        self.device_backends.clear()
        for device_name in self.DEVICE_NAMES:
            key = device_name.lower()
            backends = self._avail_backends_for_device(key)
            supports_rx = True
            supports_tx = device_name not in ("AirSpy R2", "AirSpy Mini", "FUNcube",
                                              "RTL-SDR", "RTL-TCP", "SDRPlay")
            self.device_backends[key] = BackendContainer(key, backends, supports_rx, supports_tx)
