"""``Signal.bandpass`` on a CUDA card (marked ``card``; here they skip): the
capture converted where it is staged equals the host's conversion bit for
bit, and the filtered samples come back into page-locked memory
(``xfer.to_host``) with the values of the host-converted input's filter.
Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_bandpass_card.py``
(the repository's conftest loads JAX, which the card's machine lacks).
"""

import numpy as np
import pytest
import torch

from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.core.xfer import to_host
from urh_tpu_torch.dsp.filters import Filter
from urh_tpu_torch.util import metrics

F_LOW, F_HIGH, BW = 0.02222, 0.05556, 0.01  # the band cell's, "Narrow": 401 taps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def capture(dtype, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, (n, 2)).astype(dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.float32])
def test_card_conversion_equals_the_hosts(card, dtype):
    iq = IQData(capture(dtype, 1 << 20, seed=1), skip_conversion=True)
    got = iq.staged_complex64(card)
    assert got.device.type == "cuda" and got.dtype == torch.complex64
    np.testing.assert_array_equal(got.cpu().numpy(), iq.as_complex64())


@pytest.mark.card
def test_card_bandpass_at_2_24_samples_comes_back_pinned(card):
    x = capture(np.int8, 1 << 24, seed=24)
    sig = Signal.from_iq(x, sample_rate=9e6, modulation="FSK", device=card)
    metrics.metrics.clear()
    got = sig.bandpass(F_LOW, F_HIGH, BW)
    counts = metrics.metrics.counters()
    assert counts["filter.card"] == 1 and counts["filter.samples"] == 1 << 24
    assert "filter.host" not in counts
    data = got.iq_array.data
    assert data.dtype == np.float32 and data.shape == (1 << 24, 2)
    assert torch.from_numpy(data).is_pinned()
    want = Filter.apply_bandpass_filter(IQData(x).as_complex64(), F_LOW, F_HIGH, BW, device=card)
    np.testing.assert_array_equal(data, want.view(np.float32).reshape(-1, 2))
    np.testing.assert_array_equal(sig.iq_array.data, x)  # the source is left as it was


@pytest.mark.card
def test_card_to_host_copies_into_page_locked_memory(card):
    x = torch.arange(1 << 20, dtype=torch.float32, device=card)
    got = to_host(x[1:-1])
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(got, np.arange(1, (1 << 20) - 1, dtype=np.float32))
    again = to_host(x[::2])  # strided on the card, contiguous here
    np.testing.assert_array_equal(again, np.arange(0, 1 << 20, 2, dtype=np.float32))
