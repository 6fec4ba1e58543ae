"""The frozen arithmetic against the port's kernel table (PERF.md)."""

import pytest

from portbench import work


def test_flash_bound_of_the_kernel_table():
    # internvl2-1b's prefill, S=267, H=14, K=2, D=64, causal, float32
    b, f = work.flash_work(1, 267, 267, 14, 2, 64, True, 4)
    assert round(1e3 * work.bound_s(b, f), 5) == 0.00191
    assert f / work.PEAK_FLOPS_F32 > b / work.HBM_BYTES_S   # operations


def test_paged_bound_of_the_kernel_table():
    # 4 rows, H=14, K=2, D=64, pages of 16: the table's row drew its
    # lengths on the card; 650 live keys give its 0.00021 ms (bytes)
    b, f = work.paged_work(4, 14, 2, 64, 16, 32, [200, 150, 180, 120], 4)
    assert round(1e3 * work.bound_s(b, f), 5) == 0.00021
    assert b / work.HBM_BYTES_S > f / work.PEAK_FLOPS_F32


def test_paged_work_counts_live_keys_and_pages():
    b, f = work.paged_work(2, 1, 1, 4, 4, 8, [5, 0], 4)
    assert f == 4 * 4 * 1 * 5
    assert b == 2 * 2 * 1 * 4 * 4 + 2 * 5 * 1 * 4 * 4 + 4 * 2 + 4 * 2
    # a window reads only its span's pages
    b_w, f_w = work.paged_work(1, 1, 1, 4, 4, 8, [10], 4, window=3)
    assert f_w == 4 * 4 * 3


@pytest.mark.parametrize("causal,pairs", [(False, 9), (True, 6)])
def test_flash_pairs(causal, pairs):
    _, f = work.flash_work(1, 3, 3, 2, 1, 8, causal, 4)
    assert f == 4 * 8 * 2 * pairs


def test_gemm_and_block_flops():
    assert work.gemm_flops(2, 3, 4) == 48
    # a gated block: q/k/v/o and three MLP products
    d, ff = 8, 16
    assert work.attn_block_flops(1, d, 2, 1, 4, ff, True) == \
        2 * d * (2 + 2) * 4 + 2 * 8 * d + 3 * 2 * d * ff
