"""The least time of a loop-carried chain: the Costas loop (B5).

B5 is a recursion, one sample after the other, and a gated sample (|x|^2 at
or under the noise level squared) leaves the carry as it was: its least
time is the dependent chain of one step an ungated sample,
``CHAIN_CYCLES`` cycles of one SM at the card's highest clock
(``chip_smoke.py``'s ``B5_CHAIN_CYCLES``: 30 dependent float32 operations
from the phase through the sine and cosine, the mix, the error, the clips
and the wrap back to the phase, about 4 cycles each), or the bytes the
launches must move at the card's peak bandwidth where those take longer:
each sample's two float32 components read once and its float32 value
written once.
"""

from __future__ import annotations

from benchmark import yardstick

CHAIN_CYCLES = 30 * 4
# NVIDIA H100 SXM data sheet: the highest SM clock, 1,980 MHz
SM_CLOCK_HZ = 1.98e9
COSTAS_BYTES_PER_SAMPLE = 2 * 4 + 4


def costas_least_seconds(steps: int, samples: int) -> float:
    """Least time of B5 launches that step the loop ``steps`` times over
    ``samples`` samples in all."""
    chain = steps * CHAIN_CYCLES / SM_CLOCK_HZ
    return max(chain, yardstick.least_seconds(samples * COSTAS_BYTES_PER_SAMPLE))
