"""The yardstick's counts against hand counts on tiny graphs."""

import numpy as np
import pytest

from benchmark import yardstick as ys

# 0 -> 1 twice, 1 -> 0, 1 -> 2, 2 -> 1: four distinct entries of A
EDGES = np.array([[0, 1, 1, 2, 0], [1, 0, 2, 1, 1]])
MODEL = dict(hidden_dim=2, conv_layer=1, jk=True)


def test_distinct_nnz():
    assert ys.distinct_nnz(EDGES, 3) == 4


def test_spmm_bytes_and_flops():
    # 4 x (4 + 4) values and columns, 4 x 4 row offsets, x and out 3 x 2 f32
    assert ys.spmm_bytes(4, 3, 2, 4) == 32 + 16 + 24 + 24
    assert ys.spmm_bytes(4, 3, 2, 1) == 20 + 16 + 24 + 24
    assert ys.spmm_flops(4, 2) == 16


def test_spmm_bound_is_the_larger_reckoning():
    assert ys.spmm_bound_s(4, 3, 2, 4) == pytest.approx(96 / 3.35e12)
    # 2 * 1e9 * 1000 operations at 67e12 beat 1e9 * 8 bytes at 3.35e12
    assert ys.spmm_bound_s(10**9, 1, 1000, 4) == pytest.approx(
        2e12 / 67e12)


def test_model_flops_by_hand():
    # n 3, H 2: trans 2 x 2*3*2*2 = 48, comb 2 x 2*3*4*2 = 96
    assert ys.linear_flops(3, MODEL) == 144
    # + SpMM 16 + pool 5 nodes x 2 + head 2*2*2*1
    assert ys.forward_flops(3, 4, MODEL, 1, 2, 5) == 144 + 16 + 10 + 8
    # + backward: Linears and head twice, one transposed SpMM, the pool
    assert ys.train_step_flops(3, 4, MODEL, 1, 2, 5) == (
        178 + 288 + 16 + 16 + 10)


def test_em_user_step_flops_are_about_ten_gflop():
    model = dict(hidden_dim=64, conv_layer=1, jk=True)
    flops = ys.train_step_flops(57344, 5_550_000, model, 1, 6, 700)
    assert 9.5e9 < flops < 10.5e9
