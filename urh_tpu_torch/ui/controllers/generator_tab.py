"""Generator-tab controller (headless GeneratorTabController).

Re-design of controller/GeneratorTabController.py (893 LoC): writeable
message table fed from the analysis tab, per-message modulator selection,
fuzzing, pause editing, estimated air time, and IQ generation through the
modulation backend (urh_tpu_torch.protocol.generator.GeneratorBackend) on
the controller's device (default: the CUDA card).  PyTorch port of
urh_tpu.ui.controllers.generator_tab.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.generator import GeneratorBackend
from urh_tpu_torch.ui.actions import Fuzz, InsertBitsAndPauses
from urh_tpu_torch.ui.models import GeneratorTableModel
from urh_tpu_torch.util import placement
from urh_tpu_torch.util.events import Event


class GeneratorTabController:
    def __init__(self, compare_frame_controller=None, project_manager=None, device=None):
        self.device = placement.requested(device)
        self.compare_frame_controller = compare_frame_controller
        self.project_manager = project_manager
        self.table_model = GeneratorTableModel(
            decodings=(compare_frame_controller.decodings
                       if compare_frame_controller else []),
            participants=(list(compare_frame_controller.participants)
                          if compare_frame_controller else []))
        self.table_model.controller = self
        self.modulation_was_edited = False
        self.fuzzing_started = Event(int)
        self.fuzzing_finished = Event()

        if project_manager is not None:
            self.modulators = project_manager.modulators
        else:
            self.modulators = [Modulator("Modulation")]
        self.backend = GeneratorBackend(self.table_model.protocol, self.modulators,
                                        device=self.device)

    # -- accessors ---------------------------------------------------------
    @property
    def protocol(self):
        return self.table_model.protocol

    @property
    def generator_undo_stack(self):
        return self.table_model.undo_stack

    @property
    def total_modulated_samples(self) -> int:
        return self.backend.total_modulated_samples

    def modulator_of_message(self, message) -> Modulator:
        return self.backend._modulator_of_message(message)

    # -- data inflow -------------------------------------------------------
    def add_protocol(self, proto_analyzer, index: int = -1):
        """Insert all messages of an analyzer (the tree-drop path,
        GeneratorTableModel.dropMimeData → InsertBitsAndPauses)."""
        first = len(self.protocol.messages) == 0
        self.table_model.undo_stack.push(
            InsertBitsAndPauses(self.protocol, index, proto_analyzer))
        self.table_model.update()
        if first:
            self.bootstrap_modulator(proto_analyzer)

    def bootstrap_modulator(self, protocol):
        """Initialize the default modulator from the first dropped protocol
        (GeneratorTabController.py:270-291)."""
        if len(self.modulators) != 1 or len(self.protocol.messages) == 0 \
                or self.modulation_was_edited:
            return
        modulator = self.modulators[0]
        first = protocol.messages[0]
        modulator.samples_per_symbol = first.samples_per_symbol
        modulator.bits_per_symbol = first.bits_per_symbol
        signal = getattr(protocol, "signal", None)
        if signal is not None:
            modulator.sample_rate = signal.sample_rate
            modulator.modulation_type = signal.modulation_type
            auto_freq = modulator.estimate_carrier_frequency(signal, protocol)
            if auto_freq:
                modulator.carrier_freq_hz = auto_freq
        modulator.parameters = modulator.get_default_parameters()

    # -- fuzzing ----------------------------------------------------------------
    def create_fuzzing_label(self, msg_index: int, start: int, end: int):
        """(GeneratorTabController.py:662-669)"""
        con = self.protocol
        start, end = con.messages[msg_index].convert_range(
            start, end - 1, self.table_model.proto_view, 0, False)
        return con.create_fuzzing_label(start, end, msg_index)

    def fuzz(self, mode: str):
        """Successive/Concurrent/Exhaustive fuzzing with undo
        (on_btn_fuzzing_clicked, GTC:574-588)."""
        fuzz_action = Fuzz(self.protocol, mode)
        self.table_model.undo_stack.push(fuzz_action)
        self.table_model.update()
        return fuzz_action.added_message_indices

    # -- pauses ------------------------------------------------------------------
    @property
    def pauses(self):
        return self.protocol.pauses

    def edit_pause_item(self, index: int, pause: int):
        """(GTC:397-410)"""
        self.protocol.messages[index].pause = int(pause)

    def edit_all_pause_items(self, pause: int):
        for message in self.protocol.messages:
            message.pause = int(pause)

    # -- generation -----------------------------------------------------------------
    def estimated_time_s(self) -> float:
        """Estimated air time of the whole table
        (refresh_estimated_time, GTC:641-660)."""
        if self.protocol.num_messages == 0:
            return 0.0
        avg_sample_rate = np.mean([m.sample_rate for m in self.modulators])
        return float(self.backend.total_modulated_samples / avg_sample_rate)

    def generate_iq(self):
        """Modulate the whole table into one IQ buffer (generate_file /
        prepare_modulation_buffer + modulate_data, GTC:466-536)."""
        self.backend.modulators = self.modulators
        return self.backend.generate()

    def generate_file(self, filename: str):
        data = self.generate_iq()
        from urh_tpu_torch.util.file_operator import save_data
        sample_rate = self.modulators[0].sample_rate if self.modulators else 1e6
        save_data(data.data, filename, sample_rate=sample_rate)
        return filename

    def send(self, device, repeats: int = 1):
        """Modulate and hand to a TX-capable device object (an SDR, not the
        compute device) exposing
        ``send_raw_data`` (on_btn_send_clicked path, GTC:697-751)."""
        data = self.generate_iq()
        device.send_raw_data(data.as_raw_f32(), repeats)
