"""Plain PSK analysis at the modulation a user sets: URH's auto-detection
of the rest (noise, samples a symbol, center, tolerance) over the plain
Costas loop's demodulation, then the demodulation at those parameters.

The noise floor, the segmentation, the per-message parameters with the
outcomes a rounding can give, the votes and the run machine are
:mod:`benchmark.reference.estimate`'s and :mod:`benchmark.reference.demod`'s;
the demodulated values are :mod:`benchmark.reference.costas`'.  With the
modulation given, nothing is classified and no segments are merged.
"""

from __future__ import annotations

import itertools

from benchmark.reference import costas, demod
from benchmark.reference import estimate as ref


def candidates(outcomes: list) -> tuple:
    """The votes over the messages' outcomes -> (the reference's own
    parameters or None, every parameter set a rounding can give), as
    :func:`benchmark.reference.estimate.estimate` lists them."""
    base = ref.combine("PSK", [o[0] for o in outcomes])
    if base is None:
        return None, []
    fragile = [i for i, o in enumerate(outcomes) if len(o) > 1]
    if len(fragile) <= ref.MAX_TOGETHER:
        choices = itertools.product(*[range(len(outcomes[i])) for i in fragile])
    else:
        choices = ([int(i == j) * (k + 1) for i in fragile]
                   for j in fragile for k in range(len(outcomes[j]) - 1))
    found = [base]
    for choice in choices:
        picked = [o[0] for o in outcomes]
        for i, k in zip(fragile, choice):
            picked[i] = outcomes[i][k]
        c = ref.combine("PSK", picked)
        if c is not None and c not in found:
            found.append(c)
    return base, found


def estimate(x, keep=None):
    """A capture ((n, 2), its SDR dtype) -> {modulation "PSK",
    samples_per_symbol, center, center_band, tolerance, noise, candidates},
    or None where URH's rules decide nothing.  ``keep``, a dict, receives
    the demodulated capture."""
    mags = ref.magnitudes(x)
    noise = ref.noise_level(mags)
    segs = ref.segments(mags, noise)
    rect = costas.rectangular(x, noise)
    if keep is not None:
        keep["rect"] = rect
    base, found = candidates([ref.message_outcomes(rect[a:b]) for a, b in segs])
    if base is None:
        return None
    return dict(base, modulation="PSK", noise=float(noise), candidates=found)


# a PSK Signal's parameters before any are set (urh's Signal defaults)
DEFAULTS = dict(ref.DEFAULTS, modulation="PSK")


def analyze(x):
    """estimate, then demodulate at the estimated parameters -> (params or
    None, demod.demodulate's result).  Where the estimate decides nothing
    the signal keeps its defaults (noise 0 included) and is demodulated at
    them."""
    keep = {}
    params = estimate(x, keep=keep)
    at = dict(params or DEFAULTS, pause_threshold=8)
    rect = keep["rect"] if params is not None else costas.rectangular(x, at["noise"])
    return params, demod.demodulate(x, at, rect=rect)
