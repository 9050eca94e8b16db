"""Every input the benchmark makes is a function of the seed alone."""

import numpy as np
import torch

from port_bench import data, weights
from port_bench.tests import micro


def test_retrieval_pool_is_deterministic_in_the_seed():
    mix = micro.mix("retrieval_q4")
    a = data.retrieval_pool(2 ** 31 + 11, mix, torch.device("cpu"))
    b = data.retrieval_pool(2 ** 31 + 11, mix, torch.device("cpu"))
    c = data.retrieval_pool(2 ** 31 + 12, mix, torch.device("cpu"))
    for k in a:
        assert np.array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    assert a["images_101"].dtype == np.uint8 and a["ori_input_ids_101"].dtype == np.int64


def test_captions_follow_the_layout():
    g = np.random.default_rng(0)
    ids = data.captions(g, 50, 16, (2, 10), (999, 30522))
    assert (ids[:, 0] == data.CLS).all()
    for row in ids:
        sep = int(np.nonzero(row == data.SEP)[0][0])
        assert 3 <= sep <= 11
        assert ((row[1:sep] >= 999) & (row[1:sep] < 30522)).all()
        assert (row[sep + 1:] == data.PAD).all()


def test_weights_are_deterministic_in_the_seed():
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "n.weight": (4,), "pos_embed1": (1, 5, 4)}
    a, b = weights.make_weights(shapes, 9, "cpu"), weights.make_weights(shapes, 9, "cpu")
    c = weights.make_weights(shapes, 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert not torch.equal(a["a.bias"], c["a.bias"])
    assert (a["n.weight"] - 1).abs().max() < 0.3 and (a["n.weight"] != 1).all()
