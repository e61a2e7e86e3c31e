"""The arithmetic of the end-to-end metrics, the device's busy union
and the roofline counts."""
import math

import pytest

from benchmark.harness import stats
from benchmark.harness.roofline import least_seconds, peaks
from benchmark.harness import spec

H100 = peaks("NVIDIA H100 80GB HBM3")


def test_rate_and_p90():
    assert stats.rate(48, 60.0) == pytest.approx(0.8)
    assert stats.p90([2.0]) == 2.0
    # inclusive quantiles: the 90th of 1..11 is 10
    assert stats.p90(range(1, 12)) == pytest.approx(10.0)
    assert stats.p90([1.0, 1.0, 1.0, 5.0]) == pytest.approx(3.8)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 12)]
    assert stats.union_length(iv) == pytest.approx(6.0)
    assert stats.union_length(iv, lo=1, hi=11) == pytest.approx(4.0)
    assert stats.gaps(iv, 0, 12) == [(3, 5), (6, 10)]
    assert stats.gaps(iv, -1, 13) == [(-1, 0), (3, 5), (6, 10), (12, 13)]
    assert stats.union_length([]) == 0.0


def _ms(work):
    return least_seconds([work], H100) * 1e3


def test_apply_vector3_bound_at_config1():
    """K1 at the config-1 sweep (D 60416, E 30720, Q 6, B 8, k 22) is
    bound by its operations at 0.113 ms (the kernel table's bound)."""
    rl = spec.load_module("roofline", "apply_vector3")
    nbytes, flops = rl.count(60416, 30720, 6, 8, 22)
    assert flops / H100["f32_flops_per_s"] > nbytes / H100["hbm_bytes_per_s"]
    assert round(_ms((nbytes, flops)), 3) == 0.113


def test_mass_apply_bound_at_config1():
    """K3 in plain mode at L 528 on the config-1 grid: 0.077 ms by bytes;
    a first or last B^-1 step moves four blocks, a middle one six."""
    rl = spec.load_module("roofline", "mass_apply")
    plain = rl.count(60416, 30720, 6, 528)
    assert round(_ms(plain), 3) == 0.077

    class Step:
        def __init__(self, first, last):
            self.first, self.last = first, last

    assert rl.blocks_of(None) == rl.blocks_of(Step(True, True)) == 2
    assert rl.blocks_of(Step(True, False)) == rl.blocks_of(Step(False, True)) == 4
    assert rl.blocks_of(Step(False, False)) == 6
    mid = rl.count(60416, 30720, 6, 528, 6, True)
    assert math.isclose(mid[0] - plain[0], 4 * 4 * 60416 * 528 + 4 * 60416)


def test_request_streams():
    """Uniform draws stay in the band, sorted within a request; a seed
    repeats its stream and another seed draws another."""
    import itertools

    from benchmark.harness.cell import requests

    band = {"wavelength_um": [1.5, 1.64], "designs_per_request": 8}
    r = list(itertools.islice(requests(band, 2 ** 31 + 9), 5))
    assert r == list(itertools.islice(requests(band, 2 ** 31 + 9), 5))
    assert r != list(itertools.islice(requests(band, 2 ** 31 + 10), 5))
    for wls in r:
        assert wls == sorted(wls) and all(1.5 <= w <= 1.64 for w in wls)
