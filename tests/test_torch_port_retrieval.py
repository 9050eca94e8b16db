"""The port's retrieval protocol against the JAX package's, on the same
numpy scores, and the scorer's uint8 / 255 against the host's fp32 division."""

import numpy as np
import pytest
import torch
from torch import nn

from mvlt_tpu.eval import retrieval as jax_retrieval
from mvlt_tpu_torch.eval import retrieval
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("scores", [
    [0.9, 0.1, 0.5], [0.5, 0.9, 0.1], [0.1, 0.9, 0.5],
    [0.5, 0.5, 0.5],                  # ties: candidate 0 stays first
    [0.2, 0.7, 0.2, 0.7, 0.2],        # ties behind better candidates
])
def test_rank_of_ground_truth_matches_jax(scores):
    s = np.asarray(scores, np.float32)
    assert retrieval.rank_of_ground_truth(s) == jax_retrieval.rank_of_ground_truth(s)


def _bundles(n_queries, n_cand, with_query_dim):
    rng = np.random.default_rng(0)
    out = []
    for q in range(n_queries):
        ids = np.zeros((n_cand, 8), np.int32)
        ids[:, 0] = q
        imgs = rng.integers(0, 256, (n_cand, 4, 4, 3), dtype=np.uint8)
        if with_query_dim:
            imgs, ids = np.stack([imgs, imgs]), np.stack([ids, ids + 100])
        out.append({"images_101": imgs, "ori_input_ids_101": ids})
    return out


@pytest.mark.parametrize("with_query_dim", [False, True])
def test_evaluate_retrieval_matches_jax(with_query_dim):
    """acc@k over the fixed /1000 denominator and the _true accuracies, with
    tied scores, equal the JAX protocol's on the same scores."""
    scores = np.random.default_rng(1).integers(0, 6, (1000, 101)).astype(np.float32) / 5

    def scorer(images, input_ids):
        tags = np.asarray(input_ids)[:, 0]
        return np.concatenate([scores[t] for t in tags[::101]])

    bundles = _bundles(12, 101, with_query_dim)
    got = retrieval.evaluate_retrieval(scorer, bundles, is_main=False)
    want = jax_retrieval.evaluate_retrieval(scorer, bundles, is_main=False)
    assert got == want
    assert got["num_queries"] == (24 if with_query_dim else 12)
    assert got["acc@10"] == got["acc@10_true"] * got["num_queries"] / 1000


class _Recorder(nn.Module):
    """Stands in for PVLT: records the images it is given and returns fixed
    ITM logits."""

    def __init__(self, logits):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(1))
        self.logits = logits
        self.seen = None

    def forward(self, images, input_ids):
        self.seen = images
        return {"itm_logits": self.logits[: images.shape[0]]}


def test_scorer_uint8_division_is_bit_exact():
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 4, 16, 1).repeat(3, axis=-1)
    model = _Recorder(torch.zeros(4, 1, 2))
    retrieval.make_itm_scorer(model)(u8, np.zeros((4, 8), np.int64))
    want = u8.astype(np.float32) / np.float32(255)
    assert model.seen.dtype == torch.float32
    np.testing.assert_array_equal(model.seen.numpy(), want)


def test_scorer_returns_positive_class_probability():
    logits = torch.tensor([[[0.0, 0.0]], [[1.0, -1.0]], [[-2.0, 3.0]]])
    model = _Recorder(logits)
    got = retrieval.make_itm_scorer(model)(np.zeros((3, 2, 2, 3), np.float32),
                                           np.zeros((3, 8), np.int64))
    want = torch.softmax(logits.reshape(-1, 2), dim=-1)[:, 1]
    torch.testing.assert_close(got, want)
