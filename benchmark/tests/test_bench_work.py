"""The least-work counts against hand counts at small shapes, and at the
cells' shapes against the figures the records give."""

import math

import pytest

from benchmark.harness import work

L128 = 2.5 * 128 * 7          # a real 128-point transform
FILTER_2_TAPS = 16 * 2 + 32 + 2 * (2 * L128 + 8 * 65)


def test_rfft_counts():
    assert work.rfft_flops(8) == 2.5 * 8 * 3
    assert work.rfft_flops(2048, 1024) == 2.5 * 2048 * 10   # Q 1024
    assert work.rfft_flops(2048, 100) == 2.5 * 2048 * 7     # Q 128
    assert work.rfft_flops(32768, 16448) == 2.5 * 32768 * 15


def test_filter_flops_by_hand():
    assert work.filter_flops(2) == FILTER_2_TAPS == 10064


def test_assembly_by_hand():
    s = dict(rows=3, n_fft=8, taps=2, table_rows=5)
    nbytes, flops = work.assembly(s)
    assert nbytes == 3 * 32 + 5 * 32 + 3 * 2 * 5 * 8
    assert flops == 3 * (10064 + 2 * 60)


@pytest.mark.parametrize("crossfade, S, want", [
    (True, 1, 2 * (120 + 2 * 5 * 14) + 2 * 2 * 60),
    (False, 1, 2 * (60 + 2 * 5 * 6) + 2 * 2 * 60),
    (True, 3, 3 * 2 * (120 + 2 * 5 * 16) + 2 * 2 * 60),
])
def test_mix_inverse_by_hand(crossfade, S, want):
    s = dict(S=S, nb=2, B=4, n_fft=8, rows=S * 2, crossfade=crossfade)
    nbytes, flops = work.mix_inverse(s)
    assert nbytes == S * 2 * 4 * 4 + S * 2 * 2 * 5 * 8 + 2 * 2 * 8 * 4
    assert flops == want


@pytest.mark.parametrize("crossfade, S, want", [
    (True, 1, 2 * (120 + 2 * 5 * 14)),
    (False, 1, 2 * (60 + 2 * 5 * 6)),
    (True, 3, 3 * 2 * (120 + 2 * 5 * 16)),
])
def test_mix_by_hand(crossfade, S, want):
    s = dict(S=S, nb=2, B=4, n_fft=8, rows=S * 2, crossfade=crossfade)
    nbytes, flops = work.mix(s)
    assert nbytes == S * 2 * 4 * 4 + S * 2 * 2 * 5 * 8 + 2 * 2 * 5 * 8
    assert flops == want


def test_roofline_pct():
    s = dict(S=1, nb=2, B=4, n_fft=8, rows=2, crossfade=True)
    assert work.mix(s) == (352, 520)
    least = work.least_seconds(352, 520)
    assert least == 352 / work.HBM_BYTES_PER_S
    assert work.roofline_pct(work.mix, s, 2 * least) == 50.0
    assert work.roofline_pct(work.mix, s, None) is None


def test_cell_shapes_against_the_records():
    """kemar128.trajectory's mix and inverse are bound by their bytes at
    ~0.090 ms, kemar128.scene's mix by its 170 MB at ~0.051 ms, and a
    16,384-tap table's 8192 filters by their operations (PERF.md)."""
    traj = dict(S=1, nb=8192, B=1024, n_fft=2048, rows=8192, crossfade=True)
    t = work.least_seconds(*work.mix_inverse(traj))
    assert t == pytest.approx(0.090e-3, rel=0.01)
    scene = dict(S=64, nb=128, B=1024, n_fft=2048, rows=8192, crossfade=True)
    nbytes, flops = work.mix(scene)
    assert nbytes == 64 * 128 * 1024 * 4 + 8192 * 2 * 1025 * 8 + 128 * 2 * 1025 * 8
    assert work.least_seconds(nbytes, flops) == pytest.approx(0.0507e-3, rel=0.01)
    room = dict(rows=64 * 128, n_fft=32768, taps=16384, table_rows=1008)
    nbytes, flops = work.assembly(room)
    assert 8192 * 2 * 16385 * 8 == pytest.approx(2.15e9, rel=0.01)
    assert nbytes > 2.15e9 and flops / work.FP32_FLOPS_PER_S > nbytes / work.HBM_BYTES_PER_S
    assert math.isclose(work.least_seconds(nbytes, flops),
                        flops / work.FP32_FLOPS_PER_S)
