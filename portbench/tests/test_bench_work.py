"""The nominal work counts against shapes counted by hand."""

import numpy as np
import pytest

from portbench import work

PEAK = {"float32_flops": 67e12, "memory_bytes_per_s": 3.35e12}


def test_bond_sides_follow_the_schmidt_rank_bound():
    # L = 6: bonds b = 1..5 hold at most 2, 4, 8, 4, 2 Schmidt values
    assert work.bond_sides(6, 64).tolist() == [4, 8, 16, 8, 4]
    assert work.bond_sides(6, 3).tolist() == [4, 6, 6, 6, 4]
    assert work.bond_sides(40, 72).max() == 144
    assert work.bond_sides(40, 72)[:4].tolist() == [4, 8, 16, 32]


def test_operation_and_byte_counts_by_hand():
    # n = 4: 4 (4*64 - 4*64/3) = 4 * 170.67; contraction 4*64 + 32*16
    assert work.svd_ops(4) == pytest.approx(4 * (256 - 256 / 3))
    assert work.contraction_ops(4) == 256 + 512
    assert work.svd_bytes(4) == 8 * 16 + 16


def test_periods_work_sums_every_bond_of_every_period():
    max_chi = np.array([[1, 2], [4, 4]])          # 2 chains x 2 periods
    w = work.periods_work(4, max_chi, PEAK)
    sides = np.concatenate([work.bond_sides(4, c) for c in max_chi.ravel()])
    assert w["svds"] == 4 * 3
    assert w["svd_ops"] == pytest.approx(work.svd_ops(sides).sum())
    assert w["ops"] == pytest.approx(w["svd_ops"] + work.contraction_ops(sides).sum())
    least = np.maximum(work.svd_ops(sides) / 67e12,
                       work.svd_bytes(sides) / 3.35e12)
    assert w["svd_seconds"] == pytest.approx(least.sum())
    # an n = 144 SVD is bound by its operations
    assert work.svd_ops(144) / 67e12 > work.svd_bytes(144) / 3.35e12


def test_the_peak_table_holds_the_card():
    p = work.peaks("NVIDIA H100 80GB HBM3")
    assert p["float32_flops"] == 67e12 and p["memory_bytes_per_s"] == 3.35e12
    assert work.peaks("cpu") is None
