"""The tax bridge's row sort and wash-sale matching against plain oracles.

- ``_sort_rows`` (the one lax.sort every bridge merge goes through) vs
  NumPy ``lexsort`` per row: heavy key ties so the secondary key and
  stability matter, payload counts from 0 to 5 (the bridge carries up to
  5), half-sorted "merge"/"valley" inputs like the bridge builds, an i32
  primary key, and zero and +-inf keys.
- ``_wash_matching_scan`` vs the host ``WashSaleTracker`` (tax/wash_sale.py)
  on hand-built trade sequences: nearest replacement, earliest-wins ties,
  one-use buys, partial disallowance, and the +-30-day window edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from letf_tpu.tax.device_bridge import _sort_rows, _wash_matching_scan
from letf_tpu.tax.wash_sale import WashSaleTracker


def _lexsort_rows(key, sec, pays):
    """NumPy oracle: stable row-wise order by (key, sec)."""
    order = np.stack([np.lexsort((s, k)) for k, s in zip(key, sec)])
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    return [take(key), take(sec)] + [take(p) for p in pays]


def _mk(rng, B, S, kind, n_pay, tie_quant=4):
    """Non-negative f32 keys with many ties; the secondary is the
    bridge's (half tag, position) order packed into one unique i32."""
    N = 2 * S
    key = np.abs(rng.standard_normal((B, N)).astype(np.float32))
    key = np.round(key * tie_quant) / tie_quant
    if kind in ("merge", "valley"):
        key[:, S:] = np.sort(key[:, S:], axis=1)
    if kind == "merge":
        key[:, :S] = np.sort(key[:, :S], axis=1)
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (B, N)).copy()
    pays = [rng.standard_normal((B, N)).astype(np.float32)
            for _ in range(n_pay)]
    return key, sec, pays


def _check(key, sec, pays):
    got = _sort_rows(jnp.asarray(key), jnp.asarray(sec),
                     tuple(jnp.asarray(p) for p in pays))
    want = _lexsort_rows(key, sec, pays)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("kind", ["merge", "valley", "sort"])
@pytest.mark.parametrize("n_pay", [0, 2])
def test_sort_rows_ties_and_payloads(kind, n_pay):
    rng = np.random.default_rng(7)
    _check(*_mk(rng, 130, 13, kind, n_pay))


def test_sort_rows_i32_primary():
    """The day-order restore form: unique i32 primary key, i32
    secondary, one f32 payload."""
    rng = np.random.default_rng(11)
    B, N = 16, 32
    perm = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    key = (perm << 2) | 1
    sec = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N)).copy()
    _check(key, sec, [rng.standard_normal((B, N)).astype(np.float32)])


def test_sort_rows_four_payloads():
    _check(*_mk(np.random.default_rng(13), 64, 24, "valley", 4))


def test_sort_rows_five_payloads():
    _check(*_mk(np.random.default_rng(13), 64, 24, "merge", 5))


def test_sort_rows_head_payloads_zero():
    """Pass-1 shape: the unsorted (query) half carries zero payloads."""
    key, sec, pays = _mk(np.random.default_rng(17), 64, 24, "valley", 3)
    for p in pays:
        p[:, :24] = 0.0
    _check(key, sec, pays)


def test_sort_rows_zero_and_inf_keys():
    """Rows the bridge produces with no trades (all-zero keys, every
    order decided by the secondary), and +-inf keys at both ends."""
    B, S = 8, 8
    N = 2 * S
    key = np.zeros((B, N), np.float32)
    key[1, 3] = np.inf
    key[2, [0, 9]] = -np.inf
    key[3, :] = np.inf
    key[4, ::2] = -np.inf
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (B, N)).copy()
    sec[5] = sec[5, ::-1]
    pay = np.arange(B * N, dtype=np.float32).reshape(B, N)
    _check(key, sec, [pay])


# ---------------------------------------------------------------------------
# Wash-sale matching vs the host tracker
# ---------------------------------------------------------------------------

# (day, action, shares, price). Every sequence opens with one 100-share
# lot at $50 that each later sale consumes first (the tracker costs a
# sale against the pristine FIFO lots), so a sale's loss is
# shares * (50 - price).
_SEQUENCES = {
    # Nearest buy wins (d40 over d75 for the d50 sale); replacement
    # smaller than the sale disallows pro rata (10/20, then 8/10); a
    # gain sale (d55) matches nothing.
    "partial_nearest": [(0, "BUY", 100.0, 50.0), (40, "BUY", 10.0, 45.0),
                        (50, "SELL", 20.0, 40.0), (55, "SELL", 5.0, 60.0),
                        (70, "SELL", 10.0, 41.0), (75, "BUY", 8.0, 42.0)],
    # Equidistant buys: the earlier one (d60) wins; each buy replaces
    # one sale only, so the third loss sale finds none left.
    "tie_one_use": [(0, "BUY", 100.0, 50.0), (60, "BUY", 5.0, 40.0),
                    (70, "SELL", 5.0, 45.0), (71, "SELL", 5.0, 44.0),
                    (72, "SELL", 5.0, 43.0), (80, "BUY", 5.0, 40.0)],
    # Window edges: a buy exactly 30 days before is in (d31 for d61), 31
    # days before is out (d100 for d131), and a same-day buy never
    # counts (d131).
    "window_edges": [(0, "BUY", 100.0, 50.0), (31, "BUY", 5.0, 49.0),
                     (61, "SELL", 5.0, 40.0), (100, "BUY", 3.0, 48.0),
                     (131, "BUY", 4.0, 30.0), (131, "SELL", 2.0, 30.0)],
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_wash_matching_scan_matches_host_tracker(name):
    seq = _SEQUENCES[name]
    S = 140
    tracker = WashSaleTracker()
    loss = np.zeros((1, S))
    sell = np.zeros((1, S))
    buy = np.zeros((1, S))
    for day, action, shares, price in seq:
        tracker.record_trade("TQQQ", day, action, shares, price)
        if action == "BUY":
            buy[0, day] += shares
        else:
            sell[0, day] += shares
            loss[0, day] = max(0.0, shares * (50.0 - price))
    tracker.process_all_wash_sales()

    dis, rep_off, has = (np.asarray(a) for a in _wash_matching_scan(
        jnp.asarray(loss), jnp.asarray(sell), jnp.asarray(buy)))

    want_dis = np.zeros(S)
    want_off = np.zeros(S, np.int32)
    for e in tracker.wash_sale_events:
        want_dis[e.sale_day] = e.loss_amount
        want_off[e.sale_day] = e.replacement_buy_day - e.sale_day
    np.testing.assert_array_equal(has[0], want_dis > 0)
    np.testing.assert_array_equal(rep_off[0], want_off)
    np.testing.assert_allclose(dis[0], want_dis, rtol=1e-12, atol=0.0)
    assert len(tracker.wash_sale_events) >= 1
