"""urh_tpu_torch — the PyTorch/CUDA port of urh_tpu for NVIDIA Hopper.

Offline demodulation (raw IQ -> noise gate and ASK/FSK/PSK demodulation
-> symbol states -> pulse runs -> bits -> Messages), streaming
demodulation (chunks -> run segments, :class:`StreamDemodulator`),
automatic parameter estimation (:func:`estimate`), TX synthesis
(:class:`Modulator`), filters (``dsp.filters``, ``Signal.filter_range``),
spectrograms (``dsp.spectrogram``), plot paths (``dsp.decimation``),
protocol inference (``awre``, ``ProtocolAnalyzer.auto_assign_labels``),
the live loop (``protocol.sniffer.ProtocolSniffer`` over the Network SDR
or a hardware device such as RTL-TCP, ``protocol.generator.GeneratorBackend``,
``dsp.continuous_modulator.ContinuousModulator``), the stateful
simulator (``sim.simulator.Simulator``) and the block-sharded pipeline
(``parallel.sharded``, across processes ``parallel.distributed``) run on
a CUDA card, with the kernels written by hand in CUDA C++ (``csrc/``).
The command-line interface (``python -m urh_tpu_torch.cli``), the plugins
(``plugins``) and the headless UI's model layer (``ui``: undo stack,
undoable signal and table edits, models) drive them.  Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel's plain PyTorch version runs
instead.  Imports neither JAX nor urh_tpu.

Quick start::

    import urh_tpu_torch as ut

    sig = ut.Signal.from_file("capture.complex")
    sig.auto_detect(detect_noise=True)         # or sig.modulation_type = "FSK" ...
    messages = ut.demodulate(sig)              # -> list of bit messages

    sd = ut.StreamDemodulator(ut.DemodParams(modulation="FSK", noise_threshold=0.1))
    segments = sd.feed(chunk) + sd.flush()     # -> run segments
"""

from urh_tpu_torch.ai.estimate import estimate
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.dsp.demod import DemodParams, afp_demod
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer, demodulate
from urh_tpu_torch.protocol.stream import StreamDemodulator

__version__ = "0.1.0"

__all__ = [
    "IQData",
    "Signal",
    "DemodParams",
    "afp_demod",
    "ProtocolAnalyzer",
    "demodulate",
    "StreamDemodulator",
    "estimate",
    "Modulator",
]
