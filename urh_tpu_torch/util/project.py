"""Project persistence: URHProject.xml files.

GUI-free counterpart of urh/util/ProjectManager.py (655 LoC): stores
device configuration, modulators, decodings, participants, per-signal
demodulation parameters and simulator profiles in a project XML that is
wire-compatible with the reference's format.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from xml.dom import minidom

from urh_tpu_torch.coding.encodings import Encoding
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.labels import Participant
from urh_tpu_torch.util.logging import logger


class ProjectManager:
    NEWLINE_CODE = "[NEWLINE]"

    def __init__(self, project_path: str = ""):
        self.project_path = project_path
        self.device_conf = dict(frequency=433.92e6, sample_rate=1e6, bandwidth=1e6,
                                gain=20, name="HackRF")
        self.simulator_rx_conf = dict()
        self.simulator_tx_conf = dict()
        self.simulator_num_repeat = 1
        self.simulator_retries = 10
        self.simulator_timeout_ms = 2500
        self.simulator_error_handling_index = 0

        self.description = ""
        self.broadcast_address_hex = "ffff"
        self.modulation_was_edited = False

        self.modulators = [Modulator("Modulator")]
        self.decodings = [Encoding(["Non Return To Zero (NRZ)"])]
        self.participants = []
        self.signal_infos = {}  # filename (relative) -> dict of params

    @property
    def project_file(self):
        if not self.project_path:
            return None
        return os.path.join(self.project_path, "URHProject.xml")

    def load_decodings(self):
        """Populate self.decodings from the user decodings file, else the
        built-in fallback chains (ProjectManager.py:120-158)."""
        if self.project_file:
            return
        from urh_tpu_torch.util import settings

        fallback = [
            Encoding(["Non Return To Zero (NRZ)"]),
            Encoding(["Non Return To Zero + Invert", settings.DECODING_INVERT]),
            Encoding(["Manchester I", settings.DECODING_EDGE]),
            Encoding(["Manchester II", settings.DECODING_EDGE,
                      settings.DECODING_INVERT]),
            Encoding(["Differential Manchester", settings.DECODING_EDGE,
                      settings.DECODING_DIFFERENTIAL]),
        ]
        try:
            with open(os.path.join(settings.config_dir(), "decodings.txt")) as f:
                decodings = [Encoding([part.strip().replace("'", "")
                                       for part in line.strip().split(",")])
                             for line in f if line.strip()]
        except OSError:
            decodings = []
        self.decodings = decodings if decodings else fallback

    def save_decodings_file(self):
        """Persist the decodings list to the user decodings file — the
        DecoderDialog save path when no project is open
        (ProjectManager.py:120-158 reads the same format back)."""
        from urh_tpu_torch.util import settings

        os.makedirs(settings.config_dir(), exist_ok=True)
        path = os.path.join(settings.config_dir(), "decodings.txt")
        with open(path, "w") as f:
            for decoding in self.decodings:
                f.write(", ".join(
                    "'" + str(chn) + "'"
                    for chn in decoding.get_chain()) + "\n")

    @property
    def project_loaded(self) -> bool:
        return self.project_file is not None and os.path.isfile(self.project_file)

    # -- device conf -------------------------------------------------------
    @staticmethod
    def read_device_conf_dict(tag: ET.Element, target_dict):
        if tag is None:
            return
        for dev_tag in tag:
            if dev_tag.text is None:
                continue
            try:
                try:
                    value = int(dev_tag.text)
                except ValueError:
                    value = float(dev_tag.text)
            except ValueError:
                value = dev_tag.text
            if dev_tag.tag == "bit_len":
                target_dict["samples_per_symbol"] = value  # legacy
            else:
                target_dict[dev_tag.tag] = value

    @staticmethod
    def _device_conf_dict_to_xml(key_name: str, device_conf: dict) -> ET.Element:
        result = ET.Element(key_name)
        for key in sorted(device_conf):
            sub = ET.SubElement(result, key)
            sub.text = str(device_conf[key])
        return result

    # -- save / load -------------------------------------------------------
    def save_project(self, signals=None, simulator_config=None):
        if self.project_file is None:
            return
        os.makedirs(self.project_path, exist_ok=True)

        root = ET.Element("UniversalRadioHackerProject")
        root.set("description", str(self.description).replace("\n", self.NEWLINE_CODE))
        root.set("modulation_was_edited", str(int(self.modulation_was_edited)))
        root.set("broadcast_address_hex", str(self.broadcast_address_hex))

        root.append(Modulator.modulators_to_xml_tag(self.modulators))
        root.append(Encoding.decodings_to_xml_tag(self.decodings))
        root.append(Participant.participants_to_xml_tag(self.participants))
        root.append(self._device_conf_dict_to_xml("device_conf", self.device_conf))
        root.append(self._device_conf_dict_to_xml("simulator_rx_conf", self.simulator_rx_conf))
        root.append(self._device_conf_dict_to_xml("simulator_tx_conf", self.simulator_tx_conf))

        for signal in signals or []:
            root.append(self.signal_to_xml(signal))

        if simulator_config is not None:
            root.append(simulator_config.save_to_xml())

        xmlstr = minidom.parseString(ET.tostring(root)).toprettyxml(indent="  ")
        with open(self.project_file, "w") as f:
            for line in xmlstr.split("\n"):
                if line.strip():
                    f.write(line + "\n")

    # Declarative per-signal parameter schema.  Each row:
    #   (attribute, parser, default, read names in priority order, write name)
    # default None = leave the signal untouched when the file lacks the
    # attribute; otherwise apply the default.  Read priority keeps legacy
    # spellings (qad_center, bit_length) loadable — with qad_center
    # preferred like the reference — while writes always emit the
    # canonical attribute name (ProjectManager.py:351 writes
    # 'samples_per_symbol', not 'bit_length').
    _SIGNAL_SCHEMA = (
        ("center", float, 0.0, ("qad_center", "center"), "center"),
        ("center_spacing", float, 0.1, ("center_spacing",), "center_spacing"),
        ("samples_per_symbol", int, None, ("samples_per_symbol", "bit_length"),
         "samples_per_symbol"),
        ("tolerance", int, 5, ("tolerance",), "tolerance"),
        ("noise_threshold", float, None, ("noise_threshold",), "noise_threshold"),
        ("bits_per_symbol", int, 1, ("bits_per_symbol",), "bits_per_symbol"),
        ("costas_loop_bandwidth", float, 0.1, ("costas_loop_bandwidth",),
         "costas_loop_bandwidth"),
        ("modulation_type", str, None, ("modulation_type",), "modulation_type"),
        ("pause_threshold", int, None, ("pause_threshold",), "pause_threshold"),
        ("message_length_divisor", int, None, ("message_length_divisor",),
         "message_length_divisor"),
    )

    def _relative_filename(self, signal) -> str:
        try:
            return os.path.relpath(signal.filename, self.project_path)
        except ValueError:
            return signal.filename

    def signal_to_xml(self, signal) -> ET.Element:
        tag = ET.Element("signal", attrib={
            "filename": self._relative_filename(signal),
            "name": signal.name})
        for attr, _parse, _default, _names, write_name in self._SIGNAL_SCHEMA:
            tag.set(write_name, str(getattr(signal, attr)))
        return tag

    def read_signal_info(self, signal) -> bool:
        """Apply stored parameters to a signal loaded from this project."""
        if not self.project_loaded or len(signal.filename) == 0:
            return False
        root = ET.parse(self.project_file).getroot()
        wanted = self._relative_filename(signal)

        for sig_tag in root.iter("signal"):
            if sig_tag.attrib["filename"] != wanted:
                continue
            signal.name = sig_tag.attrib["name"]
            for attr, parse, default, names, _write_name in self._SIGNAL_SCHEMA:
                raw = next((sig_tag.get(n) for n in names
                            if sig_tag.get(n)), None)
                if raw is not None:
                    setattr(signal, attr, parse(raw))
                elif default is not None:
                    setattr(signal, attr, default)
            return True
        return False

    def read_modulators_from_project_file(self) -> list:
        """(ProjectManager.py: read_modulators_from_project_file)"""
        if not self.project_file or not os.path.isfile(self.project_file):
            return []
        tree = ET.parse(self.project_file)
        return Modulator.modulators_from_xml_tag(tree.getroot())

    def load_project(self, path: str = None):
        if path is not None:
            self.project_path = (path if os.path.isdir(path)
                                 else os.path.dirname(path))
        if not self.project_loaded:
            return False
        try:
            tree = ET.parse(self.project_file)
        except ET.ParseError as e:
            logger.error("could not parse project file: " + str(e))
            return False
        root = tree.getroot()

        self.description = root.get("description", "").replace(self.NEWLINE_CODE, "\n")
        self.broadcast_address_hex = root.get("broadcast_address_hex", "ffff")
        self.modulation_was_edited = bool(int(root.get("modulation_was_edited", 0)))

        self.read_device_conf_dict(root.find("device_conf"), self.device_conf)
        self.read_device_conf_dict(root.find("simulator_rx_conf"), self.simulator_rx_conf)
        self.read_device_conf_dict(root.find("simulator_tx_conf"), self.simulator_tx_conf)

        modulators = Modulator.modulators_from_xml_tag(root)
        if modulators:
            self.modulators = modulators
        decodings = Encoding.read_decoders_from_xml_tag(root)
        if decodings:
            self.decodings = decodings
        participants = Participant.read_participants_from_xml_tag(root)
        if participants:
            self.participants = participants

        # signal roster: lets MainController.open_project re-open every
        # signal the project references (per-signal parameters are then
        # applied by read_signal_info)
        self.signal_infos = {
            sig_tag.get("filename"): dict(sig_tag.attrib)
            for sig_tag in root.iter("signal") if sig_tag.get("filename")
        }
        return True
