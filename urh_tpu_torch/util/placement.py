"""Measured placement between the CUDA card and the CPU (PyTorch port of
urh_tpu.util.placement).

urh_tpu routes small or transfer-bound work to host twins by measured
costs: a dispatch probe scales its size thresholds, a transfer probe
prices the bytes a route moves, and :func:`race` times both routes of a
call once and keeps the winner, in-process and on disk per link.  The
port makes the same choices only where the caller asks for them with
``device="auto"``.  ``device=None`` stays the card (RuntimeError without
one), ``"cuda"`` and ``"cpu"`` are honoured as given, and ``"auto"``
raises as ``None`` does when there is no card.  urh_tpu places its
default; the port does not, so a default call never leaves the card.
Only host inputs are placed: a tensor already on the card keeps its
device (``afp_demod``, ``median_filter_rows``), as urh_tpu keeps a staged
array on its device.

The host route of each placed call is the same port function on the CPU,
never a second copy of its arithmetic; the median's is the one exception,
calling the native library as urh_tpu's twin does:

=================================================  =============================================
urh_tpu host twin (``urh_tpu/...``)                port route under ``"auto"``
=================================================  =============================================
``ai/device.py`` ``cwt_haar_np``                   ``ai.device.cwt_haar`` on the device
                                                   ``classification_stats`` placed its bucket on
``ai/device.py`` ``_median_full_windows_np``       ``ai.device.median_filter_rows``: native
                                                   ``urh_median_sliding`` (k <= 64) or
                                                   ``urh_median_full_windows`` from 2^16 cells,
                                                   B7's plain version below
``ai/device.py`` ``classification_stats`` (host)   ``ai.device._stats`` on the CPU
``ai/device.py`` ``histogram`` (``np.histogram``)  ``ai.device.histogram`` on the CPU
``ai/estimate.py`` unstaged capture                ``estimate`` without staging; each stage placed
``awre/device.py`` ``_first_diff_block_np``,       ``awre.device``'s torch functions on the CPU,
``_column_value_counts_np``, ``_ngram_matrix_np``, raced under urh_tpu's keys
``_occurrence_np``, the NumPy CRC matmul
``dsp/demod.py`` ``_afp_demod_np``                 ``dsp.demod.afp_demod_vec`` on the CPU
``dsp/spectrogram.py`` ``_stft_db_np``             ``dsp.spectrogram._stft_db_device`` on the CPU
``dsp/modulate.py`` ``_synthesize_np``,            ``dsp.modulate._synthesize`` and
``_synthesize_per_sample_np``                      ``_gfsk_body`` on the CPU
=================================================  =============================================

Three differences from urh_tpu in what runs:

* :func:`race` lets a card exception through.  urh_tpu catches every
  exception there, keeps an in-process "host" verdict that is never
  saved, and runs its host twin; a card fault here stops the call and
  leaves no verdict.
* The probes catch nothing either.  They run only under ``"auto"`` with a
  card present.
* Timing includes the card's work: each timed route ends with its result
  on the host, or the probe calls ``torch.cuda.synchronize``.

The link signature also clamps the dispatch cost at BASE_OVERHEAD_S before
it takes the magnitude (urh_tpu does not), so that a card's verdicts
replay from one process to the next.

The verdicts are kept in urh_tpu's file,
``settings.config_dir()/placement_verdicts.json``, keyed by the link
signature; each package rewrites only its own keys and keeps the others.
:data:`ROUTES` counts the routes placed calls ran.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import time
from collections import Counter

import numpy as np
import torch

from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.util import settings

# dispatch cost the static thresholds were tuned for (a local chip)
BASE_OVERHEAD_S = 100e-6
TRANSFER_BYTES = 1 << 22  # the transfer probe's copy each way
RACE_MARGIN = 1.3  # the card must beat the host by this factor to win a race

# (route, "card" or "host") -> placed runs since the last reset
ROUTES: Counter = Counter()

_RACE_VERDICTS: dict = {}
_STORE_LOADED = False


def is_auto(device) -> bool:
    return isinstance(device, str) and device == "auto"


def place(device) -> tuple:
    """(the CUDA card, the CPU) for ``"auto"``; (resolve_device(device),
    None) for any other device.  Without a card ``"auto"`` raises the
    RuntimeError of ``device=None``."""
    if is_auto(device):
        return resolve_device(None), torch.device("cpu")
    return resolve_device(device), None


def requested(device):
    """What a holder of a device (a Signal, a Spectrogram, a FormatFinder)
    keeps and passes on: ``"auto"`` as it is once a card is present,
    anything else resolved."""
    card, host = place(device)
    return "auto" if host is not None else card


def count(route: str, side: str):
    ROUTES[(route, side)] += 1


def choose(route: str, device, card_wins) -> tuple:
    """(the device a call runs on, the side placement took): under
    ``"auto"`` the card and ``"card"`` when ``card_wins()`` holds, else the
    CPU and ``"host"`` (counted in ROUTES); any other device as given, and
    None."""
    card, host = place(device)
    if host is None:
        return card, None
    side = "card" if card_wins() else "host"
    count(route, side)
    return (card if side == "card" else host), side


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=1)
def dispatch_overhead_s() -> float:
    """One trivial op on the card and its synchronize (median of 3 after a
    warm call), measured once a process."""
    card = place("auto")[0]
    x = torch.zeros(1, device=card)

    def step() -> float:
        t0 = time.perf_counter()
        x.add(1)
        _sync(card)
        return time.perf_counter() - t0

    step()
    return max(1e-6, statistics.median(step() for _ in range(3)))


def scaled_threshold(base_cells: int) -> int:
    """A size threshold tuned for BASE_OVERHEAD_S, scaled by the measured
    dispatch cost: never lowered (a fast link does not make tiny device
    calls worthwhile), and inflated at most 1e6-fold so that sentinel
    sizes such as 1 << 62 stay effective."""
    if base_cells <= 0:
        return base_cells
    ratio = dispatch_overhead_s() / BASE_OVERHEAD_S
    return int(base_cells * min(max(ratio, 1.0), 1e6))


@functools.lru_cache(maxsize=1)
def transfer_s_per_byte() -> tuple:
    """(up, down) seconds a byte of TRANSFER_BYTES copied between the host
    and the card, best of 2 after a warm copy each way: the copies the
    routes make, pageable NumPy -> ``.to(card)`` and ``.cpu().numpy()``."""
    card = place("auto")[0]
    src = np.zeros(TRANSFER_BYTES // 4, np.float32)

    def round_trip() -> tuple:
        t0 = time.perf_counter()
        x = torch.from_numpy(src).to(card)
        _sync(card)
        t1 = time.perf_counter()
        x.cpu().numpy()
        return t1 - t0, time.perf_counter() - t1

    round_trip()
    times = [round_trip() for _ in range(2)]
    return (max(min(t[0] for t in times), 1e-9) / src.nbytes,
            max(min(t[1] for t in times), 1e-9) / src.nbytes)


def device_io_cost_s(bytes_up: int, bytes_down: int = 0) -> float:
    """Estimated cost of shipping a call's data to the card and its result
    back (its compute not included)."""
    up, down = transfer_s_per_byte()
    return dispatch_overhead_s() + bytes_up * up + bytes_down * down


def _link_signature() -> str:
    """The card and the order of magnitude of its dispatch cost: stored
    verdicts replay only on a link that measures the same.  Costs below
    BASE_OVERHEAD_S share its magnitude (-4): they leave every threshold as
    it is, and one H100 measured 28 µs in one process and over 31.6 µs, the
    edge where round() turns -5 into -4, in the next."""
    mag = round(math.log10(max(dispatch_overhead_s(), BASE_OVERHEAD_S)))
    return f"cuda:{torch.cuda.get_device_name()}:{mag:+d}"


def _store_path() -> str:
    return os.path.join(settings.config_dir(), "placement_verdicts.json")


def _load_store():
    """Fill the in-process verdicts from the store once a process, so a
    link's races are paid by its first process only."""
    global _STORE_LOADED
    if _STORE_LOADED:
        return
    _STORE_LOADED = True
    try:
        with open(_store_path()) as f:
            stored = json.load(f).get(_link_signature(), {})
    except (OSError, ValueError):  # no store yet, or an unreadable one
        return
    for key, verdict in stored.items():
        _RACE_VERDICTS.setdefault(key, verdict)


def _save_store():
    """Rewrite this link's verdicts and keep every other key (urh_tpu's
    links too); a store that cannot be written leaves the verdicts in this
    process only."""
    path = _store_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[_link_signature()] = dict(_RACE_VERDICTS)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass


def race(key: str, device_fn, host_fn):
    """Measured placement of one call: the first call at ``key`` warms the
    card route, times both routes (best of 2 each; each must end with its
    result on the host) and keeps the card only when it wins by
    RACE_MARGIN; later calls, and later processes on the same link, run
    only the winner.  An exception of either route comes out and leaves no
    verdict."""
    _load_store()
    verdict = _RACE_VERDICTS.get(key)
    if verdict is not None:
        side = "card" if verdict == "device" else "host"
        count(key, side)
        return device_fn() if side == "card" else host_fn()

    def best_of(fn, trials=2):
        best, result = float("inf"), None
        for _ in range(trials):
            t0 = time.perf_counter()
            result = fn()
            best = min(best, time.perf_counter() - t0)
        return best, result

    device_fn()  # warm: first launches, allocations, library loads
    t_card, card_result = best_of(device_fn)
    t_host, host_result = best_of(host_fn)
    count(key, "card")
    count(key, "host")
    pick_card = t_card * RACE_MARGIN < t_host
    _RACE_VERDICTS[key] = "device" if pick_card else "host"
    _save_store()
    return card_result if pick_card else host_result


def run(key: str, worth_racing, device, fn):
    """``fn(dev)`` (which must end with its result on the host) on the
    device the call is placed on: under ``"auto"`` raced at ``key`` between
    the card and the CPU when ``worth_racing()`` holds, the CPU otherwise
    (counted in ROUTES); any other device as given."""
    card, host = place(device)
    if host is None:
        return fn(card)
    if not worth_racing():
        count(key, "host")
        return fn(host)
    return race(key, lambda: fn(card), lambda: fn(host))
