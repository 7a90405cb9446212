"""Headless tab controllers mirroring the reference GUI workflow
(controller/MainController.py + the four tab controllers), minus widgets:
every operation is a plain method so workflows are scriptable and testable.

PyTorch port of urh_tpu.ui.controllers.  Each controller computes on the
device it is given, ``device=`` (default: the CUDA card, RuntimeError
without one; ``"cpu"``; ``"auto"`` as the calls below it place it), and
MainController hands its device to the four tab controllers and to every
Signal it loads.
"""

from urh_tpu_torch.ui.controllers.signal_frame import SignalFrameController
from urh_tpu_torch.ui.controllers.compare_frame import CompareFrameController
from urh_tpu_torch.ui.controllers.generator_tab import GeneratorTabController
from urh_tpu_torch.ui.controllers.simulator_tab import SimulatorTabController
from urh_tpu_torch.ui.controllers.main import MainController

__all__ = ["SignalFrameController", "CompareFrameController",
           "GeneratorTabController", "SimulatorTabController", "MainController"]
