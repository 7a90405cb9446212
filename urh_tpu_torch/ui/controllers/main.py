"""Top-level headless controller orchestrating the four tabs.

Re-design of controller/MainController.py (972 LoC): signal-frame
lifecycle, file dispatch by extension, project open/save, and the wiring
between Interpretation → Analysis → Generator → Simulator.

PyTorch port of urh_tpu.ui.controllers.main: ``device`` (default: the CUDA
card, RuntimeError without one) goes to the four tab controllers and to
every Signal the controller loads.
"""

from __future__ import annotations

import os

from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.ui.controllers.compare_frame import CompareFrameController
from urh_tpu_torch.ui.controllers.generator_tab import GeneratorTabController
from urh_tpu_torch.ui.controllers.signal_frame import SignalFrameController
from urh_tpu_torch.ui.controllers.simulator_tab import SimulatorTabController
from urh_tpu_torch.ui.undo import UndoStack
from urh_tpu_torch.util import placement
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.file_operator import (FUZZING_FILE_EXTENSION,
                                              PROTOCOL_FILE_EXTENSION,
                                              SIMULATOR_FILE_EXTENSION)
from urh_tpu_torch.util.project import ProjectManager


class MainController:
    def __init__(self, project_path: str = "", device=None):
        self.device = placement.requested(device)
        self.project_manager = ProjectManager(project_path)
        if project_path:
            self.project_manager.load_project()
        else:
            self.project_manager.load_decodings()

        self.undo_stack = UndoStack()  # global (signal-editing) stack
        self.signal_frames = []  # type: list[SignalFrameController]

        self.compare_frame_controller = CompareFrameController(self.project_manager,
                                                               device=self.device)
        self.generator_tab_controller = GeneratorTabController(
            self.compare_frame_controller, self.project_manager, device=self.device)
        self.simulator_tab_controller = SimulatorTabController(
            self.compare_frame_controller, self.generator_tab_controller,
            self.project_manager, device=self.device)

        self.signal_added = Event(object)
        self.signal_closed = Event(object)

    # -- signal frames ------------------------------------------------------
    def add_signal(self, signal: Signal, group_id: int = 0) -> SignalFrameController:
        """(MainController.py:429-467)"""
        frame = SignalFrameController(signal, self.undo_stack,
                                      self.project_manager)
        self.signal_frames.append(frame)
        self.project_manager.read_signal_info(signal)
        frame.show_protocol()
        self.compare_frame_controller.add_protocol(frame.proto_analyzer, group_id)
        self.signal_added.emit(frame)
        return frame

    def add_signalfile(self, filename: str, group_id: int = 0,
                       enforce_sample_rate=None) -> SignalFrameController:
        """(MainController.py:400-427)"""
        if not os.path.exists(filename):
            raise FileNotFoundError(filename)
        signal = Signal.from_file(filename, device=self.device)
        if enforce_sample_rate is not None:
            signal.sample_rate = enforce_sample_rate
        return self.add_signal(signal, group_id)

    def add_files(self, filepaths, group_id: int = 0, enforce_sample_rate=None):
        """Dispatch by extension (MainController.py:512-580)."""
        added = []
        for filename in filepaths:
            if filename.endswith(PROTOCOL_FILE_EXTENSION):
                added.append(self.add_protocol_file(filename))
            elif filename.endswith(FUZZING_FILE_EXTENSION):
                added.append(self.add_fuzz_profile(filename))
            elif filename.endswith(SIMULATOR_FILE_EXTENSION):
                added.append(self.add_simulator_profile(filename))
            elif filename.endswith(".txt"):
                added.append(self.add_plain_bits_from_txt(filename))
            else:
                added.append(self.add_signalfile(filename, group_id,
                                                 enforce_sample_rate))
        return added

    def add_protocol_file(self, filename: str):
        """(MainController.py:386-390)"""
        return self.compare_frame_controller.add_protocol_from_file(filename)

    def add_plain_bits_from_txt(self, filename: str):
        """(MainController.py:369-384)"""
        with open(filename) as f:
            protocol = ProtocolAnalyzer.get_protocol_from_string(
                [line.strip() for line in f if line.strip()])
        protocol.filename = filename
        protocol.name = os.path.splitext(os.path.basename(filename))[0]
        self.compare_frame_controller.add_protocol(protocol)
        return protocol

    def add_fuzz_profile(self, filename: str):
        """(MainController.py:392-394)"""
        from urh_tpu_torch.protocol.container import ProtocolAnalyzerContainer
        container = self.generator_tab_controller.protocol
        assert isinstance(container, ProtocolAnalyzerContainer)
        container.from_xml_file(filename)
        self.generator_tab_controller.table_model.update()
        return container

    def add_simulator_profile(self, filename: str):
        """(MainController.py:396-398)"""
        self.simulator_tab_controller.load_simulator_file(filename)
        return self.simulator_tab_controller.simulator_config

    def close_signal_frame(self, frame: SignalFrameController):
        """(MainController.py:476-510)"""
        if frame not in self.signal_frames:
            return
        self.compare_frame_controller.remove_protocol(frame.proto_analyzer)
        self.signal_frames.remove(frame)
        self.signal_closed.emit(frame)

    def close_all_files(self):
        for frame in list(self.signal_frames):
            self.close_signal_frame(frame)
        self.undo_stack.clear()

    # -- project ------------------------------------------------------------------
    def open_project(self, path: str):
        self.project_manager.load_project(path)
        self.compare_frame_controller.project_manager = self.project_manager
        for filename, _params in self.project_manager.signal_infos.items():
            full = os.path.join(self.project_manager.project_path, filename)
            if os.path.isfile(full):
                self.add_signalfile(full)

    def save_project(self):
        self.project_manager.save_project(
            signals=[frame.signal for frame in self.signal_frames],
            simulator_config=self.simulator_tab_controller.simulator_config)
