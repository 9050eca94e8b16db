"""The port's MLM cross entropy (mvlt_tpu_torch/ops/mlm_ce.py) against the
JAX package's fused kernel, on the CPU.

On a CPU tensor ``mlm_nll`` runs the kernels' plain versions; the JAX side
is mvlt_tpu/ops/mlm_ce.py:fused_mlm_loss with its Pallas kernels in
interpret mode (tests/kernel_utils.run_interpret, as tests/test_mlm_ce.py
runs them). Row and vocabulary counts do not divide either side's tiles.
Value and the three gradients agree to 2e-4 in fp32 (sums run in another
order); with every row ignored the loss and every gradient are exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch.ops.mlm_ce import (BWD_TILE, MAX_SPLITS, bwd_plan, fwd_partials,
                                       mlm_ce_bwd, mlm_ce_fwd, mlm_ce_loss, mlm_nll,
                                       mlm_nll_bwd_reference, mlm_nll_reference)
from mvlt_tpu_torch.train.losses import chunked_mlm_loss, compute_losses
from tests.kernel_utils import run_interpret
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

H = 64
TOL = 2e-4


def _data(seed, r, v, label_rate=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((r, H)).astype(np.float32),
            (rng.standard_normal((v, H)) * 0.3).astype(np.float32),
            (rng.standard_normal(v) * 0.1).astype(np.float32),
            np.where(rng.random(r) < label_rate, rng.integers(0, v, r), -1).astype(np.int32))


def _jax_loss_and_grads(rows, table, bias, labels):
    import mvlt_tpu.ops.mlm_ce as mc

    fn = jax.value_and_grad(
        lambda x, t, b: mc.fused_mlm_loss(x[None], t, b, jnp.asarray(labels)[None]),
        argnums=(0, 1, 2))
    loss, grads = run_interpret(fn, jnp.asarray(rows), jnp.asarray(table), jnp.asarray(bias))
    return float(loss), [np.asarray(g) for g in grads]


def _port_loss_and_grads(rows, table, bias, labels):
    x, t, b = (torch.from_numpy(a).requires_grad_() for a in (rows, table, bias))
    loss = mlm_ce_loss(x[None], t, b, torch.from_numpy(labels)[None])
    loss.backward()
    return float(loss.detach()), [a.grad.numpy() for a in (x, t, b)]


@pytest.mark.parametrize("r,v", [(48, 200), (130, 700)])
def test_mlm_loss_and_grads_match_jax_kernel(r, v):
    args = _data(r, r, v)
    loss_j, grads_j = _jax_loss_and_grads(*args)
    loss_p, grads_p = _port_loss_and_grads(*args)
    np.testing.assert_allclose(loss_p, loss_j, rtol=TOL, atol=TOL)
    for name, g, w in zip(("d_rows", "d_table", "d_bias"), grads_p, grads_j):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


def test_all_ignored_rows_give_exact_zeros():
    rows, table, bias, _ = _data(5, 40, 300)
    labels = np.full(40, -1, np.int32)
    loss_j, grads_j = _jax_loss_and_grads(rows, table, bias, labels)
    loss_p, grads_p = _port_loss_and_grads(rows, table, bias, labels)
    assert loss_p == 0.0 and loss_j == 0.0
    for g, w in zip(grads_p, grads_j):
        assert not np.any(g) and not np.any(w)


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors the forward and backward wrappers are the plain
    versions and launch nothing; the plain forward is the logsumexp over the
    full logits."""
    rows, table, bias, labels = (torch.from_numpy(a) for a in _data(7, 20, 90))
    launches = (mlm_ce_fwd.launches, mlm_ce_bwd.launches)
    nll, lse = mlm_ce_fwd(rows, table, bias, labels)
    want_nll, want_lse = mlm_nll_reference(rows, table, bias, labels)
    torch.testing.assert_close(nll, want_nll, rtol=0, atol=0)
    logits = rows @ table.T + bias
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-6, atol=1e-5)
    g = torch.rand(20)
    for got, want in zip(mlm_ce_bwd(rows, table, bias, labels, lse, g),
                         mlm_nll_bwd_reference(rows, table, bias, labels, lse, g)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (mlm_ce_fwd.launches, mlm_ce_bwd.launches) == launches


def test_mlm_nll_gradcheck():
    """The Function's explicit backward against autograd's numbers, fp64."""
    rows, table, bias, labels = _data(9, 11, 37, label_rate=0.6)
    x, t, b = (torch.from_numpy(a).double().requires_grad_() for a in (rows, table, bias))
    lab = torch.from_numpy(labels)
    assert torch.autograd.gradcheck(lambda x, t, b: mlm_nll(x, t, b, lab), (x, t, b))


def test_kernel_route_on_the_cpu_is_the_chunked_loss():
    """mlm_ce_kernel=True on CPU tensors takes the chunked loss, as the JAX
    package does off the TPU; both equal the fused loss's value."""
    rows, table, bias, labels = (torch.from_numpy(a) for a in _data(11, 30, 150))
    out = {"mlm_hidden": rows[None], "mlm_table": table, "mlm_bias": bias}
    batch = {"mlm_labels": labels[None]}
    got = compute_losses(out, batch, mlm_ce_kernel=True)["loss_mlm"]
    want = chunked_mlm_loss(rows[None], table, bias, labels[None], chunk=8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mlm_ce_loss(rows, table, bias, labels), want, rtol=1e-5, atol=1e-5)


def test_bwd_plan_at_the_pretraining_shape():
    """R = 3,072 gathered rows, H = 768, V = 30,522 on 132 SMs: 128-padded
    rows and vocabulary (a bf16 dl scratch of 187,957,248 bytes), and dx's
    478 vocabulary chunks in 5 ranges (144 tiles x 5 = 720 blocks fill 91%
    of 6 waves)."""
    rows_pad, vocab_pad, splits = bwd_plan(3072, 30522, 768, 132)
    assert (rows_pad, vocab_pad, splits) == (3072, 30592, 5)
    assert 2 * rows_pad * vocab_pad == 187_957_248


@pytest.mark.parametrize("rows,vocab,width,sms", [(1000, 30522, 768, 132), (70, 1000, 64, 132),
                                                  (129, 130, 256, 132), (64, 64, 768, 114),
                                                  (513, 4099, 256, 8)])
def test_bwd_plan_covers_every_chunk_with_nonempty_ranges(rows, vocab, width, sms):
    rows_pad, vocab_pad, splits = bwd_plan(rows, vocab, width, sms)
    assert rows_pad % BWD_TILE == 0 and rows <= rows_pad < rows + BWD_TILE
    assert vocab_pad % BWD_TILE == 0 and vocab <= vocab_pad < vocab + BWD_TILE
    chunks = vocab_pad // 64
    per = -(-chunks // splits)
    assert 1 <= splits <= min(MAX_SPLITS, chunks)
    assert (splits - 1) * per < chunks <= splits * per      # no range empty, none left out


@pytest.mark.parametrize("rows,vocab,tiles", [(3072, 30522, 239), (1000, 4099, 33), (64, 64, 1),
                                              (129, 130, 2)])
def test_fwd_partials_one_per_row_and_vocabulary_tile(rows, vocab, tiles):
    """The forward's partials: (max, sum of exp, picked) per row and
    128-column vocabulary tile; 8,810,496 bytes at the pre-training shape."""
    assert fwd_partials(rows, vocab) == (tiles, tiles * rows * 3)
    assert (tiles - 1) * BWD_TILE < vocab <= tiles * BWD_TILE
    if rows == 3072:
        assert 4 * fwd_partials(rows, vocab)[1] == 8_810_496
