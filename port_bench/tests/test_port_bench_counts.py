"""The FLOP and byte counts against hand counts.

Model FLOPs per pair at 256 x 256 and 128 text tokens (two FLOPs a
multiply-add; products and convolutions only), summed stage by stage from
the grid (64, 32, 16, 8), the reduced K/V rows (h/sr)^2 + 128 and the MLP
widths: PVT-Tiny's backbone with the ITM head is 8,330,677,248 FLOPs
(8.33 GFLOP); PVTv2-b1's, with 7x7 and 3x3 overlapping patch embeds and the
depthwise 3x3 over each MLP's visual rows, 8,805,944,320 (8.81 GFLOP). One
MLM row decodes 512 x 768 + 768 x 768 + 768 x 30522 multiply-adds.

Each op count on small float32 shapes, by hand:
  * attention_fwd, q [2, 3, 5, 4], k and v [2, 3, 7, 4]: 4 * 2*3*5*7*4 =
    3,360 FLOPs; bytes q 480 + k 672 + v 672 + o 480 + lse 2*3*5*4 = 120,
    2,424 in all;
  * attention_bwd on the same: 8 * 840 = 6,720 FLOPs (no recomputed q k^T);
  * ln_mlp_fwd, x [2, 3, 4], w1 [8, 4], w2 [4, 8]: 6 rows, 4 * 6*4*8 = 768;
  * ln_mlp_bwd: 8 * 6*4*8 = 1,536 (no recomputed fc1);
  * mlm_ce_fwd, 5 rows of 4 against a table of 6 rows, 3 labeled:
    2 * 3*4*6 = 144; mlm_ce_bwd 4 * 3*4*6 = 288.
"""

import pytest
import torch

from port_bench import common
from port_bench.flops import forward_per_pair, train_flops

COUNTS = common.count_modules()


def model(name):
    return common.config(name)["model"]


def test_backbone_hand_counts():
    assert forward_per_pair(model("pvlt_tiny"), 256)["backbone"] == 8_330_677_248
    assert forward_per_pair(model("pvlt_v2_tiny"), 256)["backbone"] == 8_805_944_320
    assert forward_per_pair(model("pvlt_tiny"), 256)["mlm_row"] == 2 * (
        512 * 768 + 768 * 768 + 768 * 30522)


def test_training_is_three_forwards_with_labeled_rows_only():
    f = forward_per_pair(model("pvlt_tiny"), 256)
    assert train_flops(model("pvlt_tiny"), 256, 2, 5) == pytest.approx(
        3 * (2 * (f["backbone"] + f["t2i"]) + 5 * f["mlm_row"]))


def t(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def test_attention_counts():
    q, k, v = t(2, 3, 5, 4), t(2, 3, 7, 4), t(2, 3, 7, 4)
    assert COUNTS["attention_fwd"].count(q, k, v, 0.5) == (3360, 2424)
    flops, nbytes = COUNTS["attention_bwd"].count(q, k, v, q, t(2, 3, 5), q, 0.5)
    assert flops == 6720
    assert nbytes == 480 + 672 + 672 + 480 + 120 + 480 + (480 + 672 + 672)


def test_ln_mlp_counts():
    x, w1, w2 = t(2, 3, 4), t(8, 4), t(4, 8)
    g, b, b1, b2, s = t(4), t(4), t(8), t(4), t(2)
    flops, _ = COUNTS["ln_mlp_fwd"].count(x, g, b, w1, b1, w2, b2, s, 1e-6)
    assert flops == 768
    flops, _ = COUNTS["ln_mlp_bwd"].count(x, g, b, w1, b1, w2, s, 1e-6, x)
    assert flops == 1536


def test_mlm_counts_take_the_labeled_rows():
    rows, table, bias = t(5, 4), t(6, 4), t(6)
    labels = torch.tensor([1, -1, 2, -1, 0])
    flops, _ = COUNTS["mlm_ce_fwd"].count(rows, table, bias, labels)
    assert int(flops) == 144
    flops, _ = COUNTS["mlm_ce_bwd"].count(rows, table, bias, labels, t(5), t(5))
    assert int(flops) == 288


def test_block_counts_add_their_products():
    b, n, m, d, hid = 2, 10, 6, 8, 16
    x, k = t(b, n, d), t(b, 2, m, d // 2)
    w = t(d, d)
    flops, _ = COUNTS["fused_block"].count(x, k, k, t(d), t(d), w, t(d), w, t(d), t(d), t(d),
                                           t(hid, d), t(hid), t(d, hid), t(d), heads=2,
                                           eps1=1e-6, eps2=1e-6)
    assert flops == 2 * b * n * d * d * 2 + 4 * b * n * m * d + 4 * b * n * d * hid
    flops, _ = COUNTS["fused_ln_sr_kv"].count(t(b, 16 + 3, d), (4, 4), t(d), t(d), t(d, d, 2, 2),
                                              t(d), t(d), t(d), t(2 * d, d), t(2 * d), sr=2,
                                              heads=2, eps1=1e-6, eps_sr=1e-5)
    assert flops == 2 * b * (4 + 3) * d * 2 * d + 2 * b * 4 * 4 * d * d


def test_every_count_names_a_wrapper_of_the_program():
    import mvlt_tpu_torch.models.pvlt  # noqa: F401  (loads the ops modules)
    import mvlt_tpu_torch.train.losses  # noqa: F401
    from port_bench.ops_tap import op_wrappers

    assert set(COUNTS) <= set(op_wrappers())
