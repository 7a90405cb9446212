"""RfCat: transmit bit messages through an rfcat dongle's interactive
interpreter (urh/plugins/RfCat counterpart without Qt).

The dongle is driven by writing python statements to a spawned
``rfcat -r`` REPL; configuration is a declarative command table and the
transmission is a generator of (statement, wait) steps.
"""

from __future__ import annotations

import shutil
import threading
import time
from subprocess import PIPE, Popen

from urh_tpu_torch.plugins.manager import SDRPlugin
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.logging import logger

MODULATION_MAP = {"ASK": "MOD_ASK_OOK", "FSK": "MOD_2FSK",
                  "GFSK": "MOD_GFSK", "PSK": "MOD_MSK"}

# statement templates executed in order by configure(); {} filled from kwargs
_CONFIG_SCRIPT = (
    "d.setMdmModulation({modulation})",
    "d.setFreq({freq})",
    "d.setMdmSyncMode(0)",
    "d.setMdmDRate({baud})",
    "d.setMaxPower()",
)


class RfCatPlugin(SDRPlugin):
    def __init__(self):
        super().__init__(name="RfCat")
        self.rfcat_executable = settings.read("rfcat_executable", "rfcat", str)
        self.process = None
        self.rfcat_is_open = False
        self._is_sending = False
        self._interrupt = False
        self.modulators = []
        self.project_manager = None
        self.ready = True

        self.current_send_message_changed = Event(int)
        self.sending_status_changed = Event(bool)

    # -- process lifecycle -------------------------------------------------
    @property
    def rfcat_is_found(self):
        return self.is_rfcat_executable(self.rfcat_executable)

    @staticmethod
    def is_rfcat_executable(rfcat_executable) -> bool:
        return shutil.which(rfcat_executable) is not None

    def open_rfcat(self) -> bool:
        if self.rfcat_is_open:
            return True
        try:
            self.process = Popen([self.rfcat_executable, "-r"],
                                 stdin=PIPE, stdout=PIPE, stderr=PIPE)
        except Exception as e:
            logger.debug(f"could not open RfCat ({e})")
            return False
        self.rfcat_is_open = True
        logger.debug(f"opened RfCat ({self.rfcat_executable})")
        return True

    def close_rfcat(self):
        if not self.rfcat_is_open:
            return
        try:
            self.process.kill()
            self.rfcat_is_open = False
        except Exception as e:
            logger.debug(f"could not close rfcat: {e}")

    # -- REPL driving ------------------------------------------------------
    def write_to_rfcat(self, buf: str):
        self.process.stdin.write(buf.encode("utf-8") + b"\n")
        self.process.stdin.flush()

    def set_parameter(self, param: str, log=True) -> bool:
        """Execute one statement in the dongle REPL; True on ERROR
        (reference return convention)."""
        try:
            self.write_to_rfcat(param)
            self.ready = False
        except OSError as e:
            logger.info(f"could not set parameter {param} ({e})")
            return True
        if log:
            logger.debug(param)
        return False

    def read_async(self):
        self.set_parameter("d.RFrecv(500)[0]", log=False)

    def configure_rfcat(self, modulation="MOD_ASK_OOK", freq=433920000,
                        sample_rate=2000000, samples_per_symbol=500):
        values = {"modulation": modulation, "freq": int(freq),
                  "baud": int(sample_rate // samples_per_symbol)}
        for template in _CONFIG_SCRIPT:
            self.set_parameter(template.format(**values), log=False)
        logger.info("configured RfCat: mod={modulation} freq={freq}Hz "
                    "rate={baud}baud".format(**values))

    @staticmethod
    def bit_str_to_bytearray(bits: str) -> bytearray:
        # deferred import: plugins are discovered while dev.network_sdr
        # is still importing the plugin manager
        from urh_tpu_torch.dev.network_sdr import bytes_from_bits

        return bytearray(bytes_from_bits(bits))

    def send_data(self, data) -> bool:
        statement = "d.RFxmit(b{})".format(str(bytes(data))[1:])
        return self.set_parameter(statement, log=False)

    # -- message transmission ----------------------------------------------
    @property
    def is_sending(self) -> bool:
        return self._is_sending

    @is_sending.setter
    def is_sending(self, value: bool):
        if value != self._is_sending:
            self._is_sending = value
            self.sending_status_changed.emit(value)

    def _transmission_steps(self, messages, sample_rates):
        """(payload, wait_after_s) per message, repeated per the
        num_sending_repeats setting (0 -> forever)."""
        repeats = settings.read("num_sending_repeats", 1, int) or -1
        while repeats != 0 and not self._interrupt:
            for i, msg in enumerate(messages):
                if self._interrupt:
                    return
                self.current_send_message_changed.emit(i)
                yield (self.bit_str_to_bytearray(msg.encoded_bits_str),
                       msg.pause / sample_rates[i])
            repeats -= 1 if repeats > 0 else 0

    def _send_messages(self, messages, sample_rates) -> bool:
        if not len(messages):
            return False
        self.is_sending = True
        try:
            if not self.open_rfcat():
                return False
            first = messages[0]
            self.configure_rfcat(
                modulation=MODULATION_MAP.get(
                    self.modulators[first.modulator_index].modulation_type,
                    "MOD_ASK_OOK"),
                freq=self.project_manager.device_conf["frequency"],
                sample_rate=sample_rates[0],
                samples_per_symbol=first.samples_per_symbol)
            for payload, wait_s in self._transmission_steps(messages,
                                                            sample_rates):
                if self.send_data(payload):
                    break
                time.sleep(wait_s)
            return True
        finally:
            self.is_sending = False

    def start_message_sending_thread(self, messages, sample_rates):
        self._interrupt = False
        self.sending_thread = threading.Thread(
            target=self._send_messages, args=(messages, sample_rates),
            daemon=True)
        self.sending_thread.start()

    def stop_sending_thread(self):
        self._interrupt = True
        if hasattr(self, "sending_thread"):
            self.sending_thread.join(1)
        self.close_rfcat()

    # kept for callers importing the map from the class
    MODULATION_MAP = MODULATION_MAP
