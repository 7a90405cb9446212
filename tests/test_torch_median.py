"""The forward-window median filter (B7) against urh_tpu's.

B7's plain version (median_kernels.median_filter_plain, which the CPU path
runs and the CUDA kernel equals on the card) against urh_tpu's two routes
on the same float32 rows: the XLA program _median_filtered_jax (a min/max
network plus sorted tail windows, W >= k) and the host route
median_filter_rows (np.sort windows, any W), and ai.kernels.median_filter
against urh_tpu's.  Over k in {1, 2, 3, 11, 12, 64, 65} and W in {1, k-1,
k, k+1, 1000, 2^14+3}, on values quantized so that ties occur, with +-0.0
and +-inf among them, and on Gaussian rows.

Tolerance: bit for bit, but for the sign of a zero median.  The port sorts
-0.0 below +0.0; urh_tpu's routes leave it to np.sort or to their network
and disagree with each other there, so a zero median is compared by value.
Rows holding NaN are held to urh_tpu's host route (np.sort puts NaN last);
its network differs there (jnp.minimum propagates NaN), see ROADMAP.md C.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urh_tpu.ai import device as jax_device
from urh_tpu.ai import kernels as jax_kernels
from urh_tpu_torch.ai import device as ai_device
from urh_tpu_torch.ai import kernels
from urh_tpu_torch.ai import median_kernels as mk

torch.set_num_threads(1)

KS = (1, 2, 3, 11, 12, 64, 65)
LEVELS = np.array([-0.0, 0.0, 1.0, -1.0, 0.5, 2.0, np.inf, -np.inf], np.float32)


def _grid():
    for k in KS:
        for w in sorted({1, k - 1, k, k + 1, 1000, (1 << 14) + 3} - {0}):
            yield k, w


def _rows(k, w, seed):
    """Three rows of quantized values (ties, +-0, +-inf) and two Gaussian."""
    rng = np.random.default_rng(seed)
    return np.concatenate((rng.choice(LEVELS, (3, w)),
                           rng.normal(size=(2, w)).astype(np.float32)))


def _assert_same(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    same_bits = got.view(np.int32) == want.view(np.int32)
    both_zero = (got == 0) & (want == 0)
    assert (same_bits | both_zero).all(), np.flatnonzero(~(same_bits | both_zero))[:10]


@pytest.mark.parametrize("k,w", list(_grid()))
def test_plain_version_equals_urh_tpu(k, w):
    rows = _rows(k, w, seed=k * 100003 + w)
    got = mk.median_filter(torch.from_numpy(rows), k).numpy()
    _assert_same(got, jax_device.median_filter_rows(rows, k))
    if w >= k:  # urh_tpu's XLA program assumes full windows exist
        _assert_same(got, np.asarray(jax_device._median_filtered_jax(jnp.asarray(rows), k)))
    _assert_same(kernels.median_filter(rows[0].astype(np.float64), k, device="cpu"),
                 jax_kernels.median_filter(rows[0].astype(np.float64), k))


@pytest.mark.parametrize("k", [3, 11, 12])
def test_nan_rows_follow_the_host_route(k):
    rng = np.random.default_rng(k)
    rows = rng.normal(size=(3, 500)).astype(np.float32)
    rows[0, ::7] = np.nan
    rows[1, 100:140] = np.nan  # windows of NaN only
    got = mk.median_filter(torch.from_numpy(rows), k).numpy()
    np.testing.assert_array_equal(got, jax_device.median_filter_rows(rows, k))


def test_zero_medians_sort_minus_zero_first():
    rows = np.array([[-0.0, 0.0, 0.0], [-0.0, -0.0, 0.0], [0.0, -0.0, 1.0]], np.float32)
    got = mk.median_filter(torch.from_numpy(rows), 3).numpy()
    # full windows: sorted (-0, 0, 0) -> 0; (-0, -0, 0) -> -0; (-0, 0, 1) -> 0
    assert np.signbit(got[:, 0]).tolist() == [False, True, False]
    # shrunk windows of 2 take the upper value, of 1 the value itself
    assert np.signbit(got[:, 1]).tolist() == [False, False, False]
    assert np.signbit(got[:, 2]).tolist() == [False, False, False]


def test_keys_order_every_float_class_and_round_trip():
    v = np.array([-np.inf, -3.5, -1e-45, -0.0, 0.0, 1e-45, 2.0, np.inf], np.float32)
    keys = mk.median_keys(torch.from_numpy(v))
    assert (keys[1:] > keys[:-1]).all()
    assert keys.max() < mk.NAN_KEY
    assert np.array_equal(mk.median_values(keys).numpy().view(np.int32), v.view(np.int32))
    nan = mk.median_keys(torch.tensor([float("nan"), -float("nan")]))
    assert nan.tolist() == [mk.NAN_KEY, mk.NAN_KEY]


def test_device_route_is_the_wrapper_and_counts_no_cpu_launch():
    before = dict(mk.LAUNCHES)
    rows = torch.from_numpy(_rows(11, 300, seed=5))
    assert torch.equal(ai_device.median_filter_rows(rows, 11), mk.median_filter_plain(rows, 11))
    assert mk.LAUNCHES == before
    # windows wider than the row shrink to it
    assert torch.equal(mk.median_filter(rows, 1000), mk.median_filter(rows, 300))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rows = torch.zeros((2, 10))
    with pytest.raises(ValueError):
        mk.median_filter(rows, 0)
    with pytest.raises(TypeError):
        mk.median_filter(rows.double(), 3)
    with pytest.raises(ValueError):
        mk.median_filter(rows.t(), 3)
