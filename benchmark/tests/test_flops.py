"""The FLOP and byte counts of ``benchmark/flops.py``, pinned, and every
share of a peak below 100% at the rates the records predict."""

import pytest

from benchmark import flops, harness


def _cfg(name):
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def test_forward_flops_per_tile():
    assert flops.forward_flops_per_tile(_cfg("single")) == 25_979_650_304
    assert flops.forward_flops_per_tile(_cfg("double")) == 14_915_076_352
    assert flops.train_flops_per_tile(_cfg("single")) == 3 * 25_979_650_304


def test_k1_counts():
    single, double = _cfg("single"), _cfg("double")
    assert flops.k1_tile_bytes(single, 64) == 301_989_888
    assert flops.k1_tile_bytes(double, 64) == 301_989_888  # one 2 -> 2x64 call
    assert flops.k1_param_bytes(single) == 9 * 2 * 128 * 2 + 2 * 128 * 4
    assert flops.k1_least_seconds(single, 64) == pytest.approx(0.0901e-3, rel=2e-3)


@pytest.mark.parametrize("config,tiles_per_s,factor", [
    ("single", 3_200, 1), ("single", 10_000, 1), ("single", 1_650, 3), ("double", 1_900, 3),
])
def test_shares_of_the_peak_stay_under_100(config, tiles_per_s, factor):
    cfg = _cfg(config)
    assert 0 < 100 * factor * flops.forward_flops_per_tile(cfg) * tiles_per_s \
        / flops.PEAK_BF16_FLOPS < 100


def test_k1_roofline_under_100_at_the_recorded_kernel_time():
    # K1's recorded device time on the H100: 0.1327-0.1379 ms per 64 rows
    share = 100 * flops.k1_least_seconds(_cfg("single"), 64) / 0.1327e-3
    assert 60 < share < 100
