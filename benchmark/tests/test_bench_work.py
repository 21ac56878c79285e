"""The operation and byte counts against hand counts at tiny shapes."""

import numpy as np
import pytest

from benchmark import work


def test_unet_flops_by_hand():
    # 8x8 grid, 3 input channels, one level of 4 channels, k = 3, 2 out
    # stem 1x1: 2*64*3*4 = 1536; down 4x4 out: 2*16*4*9*4 = 4608;
    # bottleneck at 4x4: 4608; up (transposed, over its 4x4 inputs): 4608;
    # mix at 8x8 from 4+4 channels: 2*64*8*9*4 = 36864; head: 2*64*4*2 = 1024
    assert work.unet_flops(8, 8, 3, [4], 3, 2) == 1536 + 4608 * 3 + 36864 + 1024


def test_unet_flops_two_levels_and_odd_sizes():
    # 6x6, cin 1, channels (2, 3), k 1: levels 6x6 -> 3x3 -> 2x2
    f = (2 * 36 * 1 * 2            # stem
         + 2 * 9 * 2 * 2           # down_0 -> 3x3, 2->2
         + 2 * 4 * 2 * 3           # down_1 -> 2x2, 2->3
         + 2 * 4 * 3 * 3           # bottleneck 2x2, 3->3
         + 2 * 4 * 3 * 3           # up_1 over 2x2 inputs, 3->3
         + 2 * 9 * (3 + 2) * 3     # mix_1 at 3x3, skip 2
         + 2 * 9 * 3 * 2           # up_0 over 3x3 inputs, 3->2
         + 2 * 36 * (2 + 2) * 2    # mix_0 at 6x6, skip = stem width 2
         + 2 * 36 * 2 * 5)         # head 2->5
    assert work.unet_flops(6, 6, 1, [2, 3], 1, 5) == f


def test_encode_work_counts_only_nonzero_pairs_and_live_points():
    g = np.arange(5, dtype=np.float32)
    x = np.array([[0.0, 0.0], [4.0, 4.0], [-1e3, -1e3]], np.float32)
    mask = np.array([1.0, 0.0, 0.0], np.float32)
    # l = 0.1: exp(-50 d^2) != 0 in f32 for d <= 1 (e^-50) but 0 for d = 2 (e^-200)
    flops, nbytes = work.encode_work(g, g, x, mask, 1, 0.1)
    assert flops == 2.0 * 2 * (2 * 2)           # 2(C+1) per pair, 2x2 reached cells
    assert nbytes == 4 * (6 + 3 + 3) + 4 * 25 * 2
    gflops, gbytes = work.encode_grad_work(g, g, x, mask, 1, 0.1)
    assert gflops == 2 * flops
    assert gbytes == 4 * (6 + 3 + 3) + 2 * 4 * 4 * 2 + 4


def test_decode_grid_work_by_hand():
    g = np.arange(4, dtype=np.float32)
    t = np.array([0.0, 3.0], np.float32)
    # l = 0.1: each target row reaches 2 of the 4 source rows (d = 0, 1)
    flops, nbytes = work.decode_grid_work(g, g, t, t, 0.1, 3, 5, 2)
    nnz = 4.0
    assert flops == 2.0 * 3 * 5 * min(4 * nnz + 2 * nnz, 4 * nnz + 2 * nnz)
    assert nbytes == 3 * 16 * 5 * 2 + 4.0 * 3 * 4 * 5 + 4 * 12


def test_decode_offgrid_flops_by_hand():
    g = np.arange(4, dtype=np.float32)
    xt = np.array([[0.0, 1.5]], np.float32)
    # rows reached: d = 0, 1 -> 2; columns: d = 0.5, 0.5, 1.5 -> 2 (e^-112.5 is 0)
    assert work.decode_offgrid_flops(g, g, xt, 3, 0.1) == 2.0 * 3 * 2 * (2 + 1)


@pytest.mark.parametrize("flops,nbytes,expect", [
    (495e12, 1.0, 1.0), (1.0, 3.35e12, 1.0), (990e12, 3.35e12, 2.0)])
def test_card_bound(flops, nbytes, expect):
    assert work.card_bound_s(flops, nbytes) == pytest.approx(expect)


def test_mlp_flops():
    assert work.mlp_flops(10, [3, 4, 2]) == 2 * 10 * (12 + 8)
