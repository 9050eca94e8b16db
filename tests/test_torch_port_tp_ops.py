"""The tensor-parallel modes of kernels #12-#15 through their plain versions,
on the CPU in fp64.

#12/#13 on a rank's slice of the hidden (W1 and b1 its rows, W2 its
columns) at tp = 2 and 4: the forward partials summed, with b2 and x added
once, equal ``ln_mlp_reference`` on the whole hidden; the backward's dx
partials summed, with the dy passthrough added once, and its dgamma and
dbeta summed equal ``ln_mlp_bwd_reference``'s, its dW1, db1 and dW2 are the
rank's slices of the whole ones and its db2 the whole one on every rank,
with a DropPath scale of 0 on one sample. #14/#15 on a rank's rows of a
vocabulary of 30 (tp = 2: two ranges of an odd 15) with labels in every
range and -1: the logsumexp of the ranks' lse and the sum of their picks
give ``mlm_nll_reference``'s nll and lse; the backward on the global lse
gives d_rows partials that sum to the whole one and the rank's rows of
d_table and d_bias. Every wrapper takes the plain version on a CPU tensor
and counts no launch.
"""

import pytest
import torch

from mvlt_tpu_torch.ops import fused_mlp, mlm_ce
from mvlt_tpu_torch.parallel.tensor import COL, ROW, shard_tensor
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=1e-10, atol=1e-12)


def _mlp_inputs(d=64, hidden=256, b=3, n=37):
    gen = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64)
    r = lambda *s, std=1.0: std * torch.randn(*s, generator=gen, **f64)  # noqa: E731
    return dict(x=r(b, n, d), gamma=1 + r(d, std=0.1), beta=r(d, std=0.1),
                w1=r(hidden, d, std=d ** -0.5), b1=r(hidden, std=0.1),
                w2=r(d, hidden, std=hidden ** -0.5), b2=r(d, std=0.1),
                s=torch.tensor([1 / 0.9, 0.0, 1 / 0.9], **f64), dy=r(b, n, d))


def _slices(a, r, tp):
    return (shard_tensor(a["w1"], ROW, r, tp), shard_tensor(a["b1"], ROW, r, tp),
            shard_tensor(a["w2"], COL, r, tp))


@pytest.mark.parametrize("tp", [2, 4])
def test_ln_mlp_tp_modes_sum_to_the_whole(tp):
    a = _mlp_inputs()
    launches = (fused_mlp.ln_mlp_fwd_tp.launches, fused_mlp.ln_mlp_bwd_tp.launches)
    want = fused_mlp.ln_mlp_reference(a["x"], a["gamma"], a["beta"], a["w1"], a["b1"],
                                      a["w2"], a["b2"], a["s"], 1e-6)
    parts = [fused_mlp.ln_mlp_fwd_tp(a["x"], a["gamma"], a["beta"], *_slices(a, r, tp),
                                     a["s"], 1e-6) for r in range(tp)]
    got = a["x"] + sum(parts) + a["s"][:, None, None] * a["b2"]
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got[1], a["x"][1])              # a dropped sample: y = x

    w_dx, w_dg, w_db, w_dw1, w_db1, w_dw2, w_db2 = fused_mlp.ln_mlp_bwd_reference(
        a["x"], a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["s"], 1e-6, a["dy"])
    outs = [fused_mlp.ln_mlp_bwd_tp(a["x"], a["gamma"], a["beta"], *_slices(a, r, tp), a["s"],
                                    1e-6, a["dy"]) for r in range(tp)]
    torch.testing.assert_close(a["dy"] + sum(o[0] for o in outs), w_dx, **TOL)
    torch.testing.assert_close(sum(o[1] for o in outs), w_dg, **TOL)
    torch.testing.assert_close(sum(o[2] for o in outs), w_db, **TOL)
    torch.testing.assert_close(torch.cat([o[3] for o in outs]), w_dw1, **TOL)
    torch.testing.assert_close(torch.cat([o[4] for o in outs]), w_db1, **TOL)
    torch.testing.assert_close(torch.cat([o[5] for o in outs], dim=1), w_dw2, **TOL)
    for o in outs:
        torch.testing.assert_close(o[6], w_db2, **TOL)
        assert float(o[0][1].abs().max()) == 0.0      # no passthrough, s = 0: nothing
    assert (fused_mlp.ln_mlp_fwd_tp.launches, fused_mlp.ln_mlp_bwd_tp.launches) == launches


def test_mlm_ce_tp_modes_combine_to_the_whole():
    gen = torch.Generator().manual_seed(1)
    rows_n, width, vocab, tp = 57, 16, 30, 2
    rows = torch.randn(rows_n, width, generator=gen, dtype=torch.float64)
    table = 0.5 * torch.randn(vocab, width, generator=gen, dtype=torch.float64)
    bias = 0.1 * torch.randn(vocab, generator=gen, dtype=torch.float64)
    labels = torch.randint(0, vocab, (rows_n,), generator=gen)
    labels[::5] = -1
    labels[1], labels[2], labels[3] = 0, 14, 15         # both ranges' edges
    g = torch.randn(rows_n, generator=gen, dtype=torch.float64)
    width_v = vocab // tp
    launches = (mlm_ce.mlm_ce_fwd_tp.launches, mlm_ce.mlm_ce_bwd_tp.launches)
    nll, lse = mlm_ce.mlm_nll_reference(rows, table, bias, labels)
    parts = [mlm_ce.mlm_ce_fwd_tp(rows, table[r * width_v:(r + 1) * width_v],
                                  bias[r * width_v:(r + 1) * width_v], labels, r * width_v)
             for r in range(tp)]
    got_lse = torch.logsumexp(torch.stack([p[0] for p in parts]), 0)
    got_nll = torch.where(labels >= 0, got_lse - sum(p[1] for p in parts), 0.0)
    torch.testing.assert_close(got_lse, lse, **TOL)
    torch.testing.assert_close(got_nll, nll, **TOL)
    for r, (_, picked) in enumerate(parts):            # a pick only inside the range
        inside = (labels >= r * width_v) & (labels < (r + 1) * width_v)
        assert bool((picked[~inside] == 0).all()) and bool((picked[inside] != 0).all())

    w_rows, w_table, w_bias = mlm_ce.mlm_nll_bwd_reference(rows, table, bias, labels, lse, g)
    outs = [mlm_ce.mlm_ce_bwd_tp(rows, table[r * width_v:(r + 1) * width_v],
                                 bias[r * width_v:(r + 1) * width_v], labels, got_lse, g,
                                 r * width_v) for r in range(tp)]
    torch.testing.assert_close(sum(o[0] for o in outs), w_rows, **TOL)
    torch.testing.assert_close(torch.cat([o[1] for o in outs]), w_table, **TOL)
    torch.testing.assert_close(torch.cat([o[2] for o in outs]), w_bias, **TOL)
    assert float(sum(o[0] for o in outs)[labels < 0].abs().max()) == 0.0
    assert (mlm_ce.mlm_ce_fwd_tp.launches, mlm_ce.mlm_ce_bwd_tp.launches) == launches
