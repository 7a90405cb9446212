"""Per-signal controller: the Interpretation tab's SignalFrame without the
widget (controller/widgets/SignalFrame.py, 1,680 LoC there — the drawing
half is covered by urh_tpu_torch.ui.plots / urh_tpu_torch.dsp.decimation; this class
carries the editing/demod-workflow half).

PyTorch port of urh_tpu.ui.controllers.signal_frame: the demodulation, the
undoable edits and selection_info run on the signal's device, as
urh_tpu_torch.ui.actions do."""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.ui.actions import (ChangeSignalParameter, EditAction,
                                      EditSignalAction)
from urh_tpu_torch.ui.undo import UndoStack
from urh_tpu_torch.util.events import Event


class SignalFrameController:
    def __init__(self, signal, undo_stack: UndoStack = None, project_manager=None):
        self.signal = signal
        self.undo_stack = undo_stack if undo_stack is not None else UndoStack()
        self.project_manager = project_manager
        self.proto_analyzer = ProtocolAnalyzer(signal)
        self.proto_view = 0
        self.show_protocol_active = False
        self.protocol_updated = Event()
        # clipboard for copy/paste of IQ ranges (SignalFrame stores it on Qt)
        self.stored_data = None

    @property
    def name(self) -> str:
        return self.signal.name

    # -- demod/protocol -------------------------------------------------------
    def show_protocol(self, refresh: bool = False):
        """Demodulate and populate the protocol view
        (SignalFrame.show_protocol)."""
        if not self.show_protocol_active or refresh:
            self.proto_analyzer.get_protocol_from_signal()
            self.show_protocol_active = True
            self.protocol_updated.emit()
        return self.proto_analyzer

    def auto_detect(self, detect_modulation=True, detect_noise=False) -> bool:
        success = self.signal.auto_detect(detect_modulation, detect_noise)
        if success and self.show_protocol_active:
            self.show_protocol(refresh=True)
        return success

    # -- undoable parameter changes ------------------------------------------
    def change_parameter(self, name: str, value):
        """Set a demod parameter with undo; re-demodulates if the protocol
        view is active (SignalFrame's spinbox handlers →
        ChangeSignalParameter)."""
        cmd = ChangeSignalParameter(
            self.signal, self.proto_analyzer if self.show_protocol_active else None,
            name, value)
        self.undo_stack.push(cmd)
        if self.show_protocol_active:
            self.protocol_updated.emit()

    # -- undoable sample edits --------------------------------------------------
    def _push_edit(self, mode: EditAction, **kwargs):
        cmd = EditSignalAction(
            self.signal, mode,
            protocol=self.proto_analyzer if self.show_protocol_active else None,
            **kwargs)
        self.undo_stack.push(cmd)
        if self.show_protocol_active:
            self.protocol_updated.emit()

    def crop(self, start: int, end: int):
        self._push_edit(EditAction.crop, start=start, end=end)

    def delete_range(self, start: int, end: int):
        self._push_edit(EditAction.delete, start=start, end=end)

    def mute_range(self, start: int, end: int):
        self._push_edit(EditAction.mute, start=start, end=end)

    def filter_range(self, start: int, end: int, dsp_filter):
        self._push_edit(EditAction.filter, start=start, end=end,
                        dsp_filter=dsp_filter)

    def copy_range(self, start: int, end: int):
        self.stored_data = np.copy(self.signal.iq_array[start:end])

    def paste(self, position: int):
        if self.stored_data is not None:
            self._push_edit(EditAction.paste, position=position,
                            data_to_insert=self.stored_data)

    def insert_data(self, position: int, data):
        self._push_edit(EditAction.insert, position=position, data_to_insert=data)

    # -- selection info ------------------------------------------------------------
    def selection_info(self, start: int, end: int) -> dict:
        """Samples/time/bit content of a sample selection (SignalFrame's
        selection status bar)."""
        num = max(0, end - start)
        info = {"num_samples": num,
                "duration_s": num / self.signal.sample_rate if num else 0.0}
        if self.show_protocol_active and num:
            bits = self.proto_analyzer.get_bitseq_from_selection(start, num)
            info["selected_bits"] = bits
        return info
