"""The fused_attn_train route of the port against the JAX package, on the CPU.

The plain versions the Hopper kernels of csrc/block_attention_train.cu are
held to on the card (ops/block_attention.py: the training forward with and
without statistics, the explicit backward in its recompute and
saved-statistics forms) are held here to
mvlt_tpu/ops/block_attention.py:fused_block_attention, run in interpret mode
(Pallas #6, #7 and #8), in fp32 at rtol = atol = 1e-4 (the JAX kernels take
one-pass LN statistics and an exp2 softmax): the output, the statistics
(the row max brought from exp2 to natural units, the 8-lane padding
dropped) and the gradients of all nine inputs, with a row scale that drops
one sample. The autograd Function passes fp64 gradcheck in both forms. A
training step of the micro model on the route, at both backward forms and
both parities, matches the JAX step (whose CPU backend computes the same
function in XLA: the JAX model's gate wants a TPU) at the tolerances of
tests/test_torch_port_train.py. The route's launches are counted through
the plain versions: the fused call on every block in training mode, the
default route's attention (#10/#11) in eval mode with a gradient.
"""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch.models.pvlt import Block
from mvlt_tpu_torch.ops import block_attention as fba
from mvlt_tpu_torch.ops import pallas_attention
from mvlt_tpu_torch.ops.block_attention import (block_attention_bwd_reference,
                                                block_attention_train_reference,
                                                fused_block_attention_train)
from mvlt_tpu_torch.train.step import make_train_step
from tests.kernel_utils import run_interpret
from tests.test_torch_port_train import (LOSS_KEYS, _port_state, check_step_against_jax, jax_step,
                                         one_torch_thread)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
GRADS = ("dx", "dk", "dv", "dgamma", "dbeta", "dWq", "dbq", "dWp", "dbp")

__all__ = ["jax_step"]   # the JAX step fixture, shared with test_torch_port_train.py


def _inputs(n, d, h, m, seed):
    """fp32 numpy inputs: x and dy at unit scale, K/V and the matrices at
    gain / sqrt(fan_in) (gain 1.5 on Q, so the softmax is peaked), LN affine
    near (1, 0), a row scale with a dropped sample."""
    rng = np.random.default_rng(seed)
    hd = d // h
    mk = lambda *s, std=1.0, mean=0.0: (mean + std * rng.normal(size=s)).astype(np.float32)
    return dict(x=mk(3, n, d), k=mk(3, h, m, hd), v=mk(3, h, m, hd),
                g=mk(d, std=0.1, mean=1.0), be=mk(d, std=0.1),
                wq=mk(d, d, std=1.5 * d ** -0.5), bq=mk(d, std=0.05),   # JAX layout [in, out]
                wp=mk(d, d, std=d ** -0.5), bp=mk(d, std=0.05),
                s=np.asarray([0.0, 1.25, 1.25], np.float32), dy=mk(3, n, d))


def _port_args(a):
    """The port's argument order, Linear weights in torch layout [out, in]."""
    return (T(a["x"]), T(a["k"]), T(a["v"]), T(a["g"]), T(a["be"]), T(a["wq"].T.copy()),
            T(a["bq"]), T(a["wp"].T.copy()), T(a["bp"]))


@pytest.mark.parametrize("save_stats", [False, True])
@pytest.mark.parametrize("n,d,h,m", [(96, 64, 1, 24),      # stage-1-like
                                     (40, 128, 2, 20),     # two heads
                                     (67, 96, 3, 22)])     # ragged: D off 128, hd 32
def test_twins_match_pallas(n, d, h, m, save_stats):
    """Forward, statistics and the nine gradients (the backward form
    ``save_stats`` picks) against Pallas #6/#7/#8 in interpret mode."""
    from mvlt_tpu.ops.block_attention import _fba_impl_stats, fused_block_attention

    a = _inputs(n, d, h, m, seed=n + d)
    kw = dict(scale=(d // h) ** -0.5, eps=1e-6, num_heads=h)
    names = ("x", "k", "v", "g", "be", "wq", "bq", "wp", "bp")
    jargs = [a[k] for k in names]

    def loss(*args):
        return jnp.sum(fused_block_attention(*args, a["s"], save_stats=save_stats, **kw)
                       * a["dy"])

    want_g = run_interpret(jax.grad(loss, argnums=tuple(range(9))), *jargs)
    args = _port_args(a)
    row_scale = T(a["s"])
    if save_stats:
        want_y, want_st = run_interpret(_fba_impl_stats, *jargs, a["s"], **kw)
        got_y, got_st = block_attention_train_reference(*args, row_scale, heads=h, eps=1e-6,
                                                        save_stats=True)
        want_st = np.asarray(want_st)[..., :2 + 2 * h].copy()
        want_st[..., 2::2] /= math.log2(math.e)         # row max: exp2 units -> natural
        np.testing.assert_allclose(got_st.numpy(), want_st, **TOL)
    else:
        want_y = run_interpret(fused_block_attention, *jargs, a["s"], **kw)
        got_y, got_st = block_attention_train_reference(*args, row_scale, heads=h,
                                                        eps=1e-6), None
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    got = block_attention_bwd_reference(*args[:8], row_scale, T(a["dy"]), heads=h, eps=1e-6,
                                        stats=got_st)
    order = dict(zip(GRADS, got))
    port_g = [order["dx"], order["dk"], order["dv"], order["dgamma"], order["dbeta"],
              order["dWq"].T, order["dbq"], order["dWp"].T, order["dbp"]]
    for name, g, w in zip(names, port_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    # the dropped sample: dx is dy, and no other gradient sees its rows
    np.testing.assert_array_equal(order["dx"][0].numpy(), a["dy"][0])
    assert not order["dk"][0].any() and not order["dv"][0].any()


@pytest.mark.parametrize("save_stats", [False, True])
def test_function_passes_gradcheck(save_stats):
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64, requires_grad=True)
    b, n, d, h, m = 3, 7, 16, 2, 5
    s = torch.tensor([0.0, 1.25, 0.8], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: fused_block_attention_train(*a, s, heads=h, eps=1e-6, save_stats=save_stats),
        (r(b, n, d), r(b, h, m, d // h), r(b, h, m, d // h), r(d), r(d), r(d, d), r(d),
         r(d, d), r(d)))


def _fused_cfg(pcfg, save_stats):
    return dataclasses.replace(pcfg, fused_attn_train=True, fused_attn_stats=save_stats)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("save_stats", [False, True])
def test_step_on_the_route_matches_jax(jax_step, save_stats, step):
    """Losses, every gradient and the new BatchNorm statistics of a step on
    the route (step 1 on the masked images) against the JAX step."""
    check_step_against_jax(jax_step, _fused_cfg(jax_step[1], save_stats), step, True)


def _counted():
    """Patch the four plain versions of the two attention routes with
    counting wrappers; returns the patches and their mocks."""
    targets = [(pallas_attention, "attention_stats_reference"),
               (pallas_attention, "attention_stats_bwd_reference"),
               (fba, "block_attention_train_reference"),
               (fba, "block_attention_bwd_reference")]
    return [mock.patch.object(mod, name, wraps=getattr(mod, name)) for mod, name in targets]


@pytest.mark.parametrize("save_stats", [False, True])
def test_route_launches(jax_step, save_stats):
    """Training mode: the fused forward and backward once per block (8),
    the default route's attention (#10/#11) never, the stats form handing
    its statistics to the backward; eval mode with a gradient wanted: the
    default route on every block and the fused call never."""
    _, pcfg, params, stats, batch, _ = jax_step
    cfg = _fused_cfg(pcfg, save_stats)
    state = _port_state(cfg, params, stats, 0)
    blocks = sum(cfg.depths)
    patches = _counted()
    mocks = [p.start() for p in patches]
    try:
        state, losses = make_train_step(cfg)(state, batch)
        assert [mk.call_count for mk in mocks] == [0, 0, blocks, blocks]
        assert all((c.kwargs["stats"] is not None) == save_stats
                   for c in mocks[3].call_args_list)
        assert all(np.isfinite(float(losses[k])) for k in LOSS_KEYS)
        for mk in mocks:
            mk.reset_mock()
        model = state.model.eval()
        out = model(torch.from_numpy(batch["images"][:2]),
                    torch.from_numpy(batch["input_ids"][:2]).long())
        out["itm_logits"].sum().backward()
        assert [mk.call_count for mk in mocks] == [blocks, blocks, 0, 0]
    finally:
        for p in patches:
            p.stop()


def test_route_is_v1_training_only():
    """The flag leaves a block's eval-mode forward and its eval-mode
    gradient route as they were; a v2 block trains on the default route
    whatever the flag says (mvlt_tpu/models/pvlt.py:861-866), its output
    equal to a v2 block's without it on the same DropPath draws."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16 + 3, 16, generator=gen)
    plain = Block(16, 2, 2.0, 2, True).eval()
    fused = Block(16, 2, 2.0, 2, True, fused_attn_train=True).eval()
    fused.load_state_dict(plain.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fused(x, (4, 4)), plain(x, (4, 4)), rtol=0, atol=0)
    v2 = Block(16, 2, 2.0, 2, True, drop_path=0.5, v2=True, fused_attn_train=True).train()
    v2_default = Block(16, 2, 2.0, 2, True, drop_path=0.5, v2=True).train()
    v2_default.load_state_dict(v2.state_dict())
    with mock.patch.object(fba, "block_attention_train_fwd",
                           wraps=fba.block_attention_train_fwd) as fused_fwd:
        out = v2(x, (4, 4), torch.Generator().manual_seed(3))
    assert fused_fwd.call_count == 0
    torch.testing.assert_close(out, v2_default(x, (4, 4), torch.Generator().manual_seed(3)),
                               rtol=0, atol=0)


def test_route_matches_the_default_route_with_drop_path():
    """With DropPath on, one block's output and gradients on the route equal
    the default route's on the same generator state: the row scale is drawn
    in the same order and scales the projection only."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 16 + 5, 32, generator=gen)
    blk = Block(32, 2, 2.0, 2, True, drop_path=0.5).train()
    results = []
    for flag in (False, True):
        blk.fused_attn_train = flag
        xi = x.clone().requires_grad_()
        out = blk(xi, (4, 4), torch.Generator().manual_seed(7))
        grads = torch.autograd.grad(out.sum(), [xi] + list(blk.parameters()))
        results.append((out.detach(), grads))
    (out_d, g_d), (out_f, g_f) = results
    torch.testing.assert_close(out_f, out_d, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_f, g_d):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rows,d,splits", [(633_600, 64, 60), (172_800, 128, 60),
                                           (57_600, 320, 7), (28_800, 512, 4)])
def test_bwd_plan_at_the_stage_shapes(rows, d, splits):
    """The four pvlt_tiny stages at B = 150 on 132 SMs: dWq and dWp take
    2 x ceil(D/128)^2 output tiles (2, 2, 18, 32), times the row ranges
    the fewest blocks that fill 90% of a wave (120, 120, 126, 128)."""
    assert fba.bwd_plan(rows, d, 132) == splits


@pytest.mark.parametrize("rows,d,sms", [(600, 96, 132), (154, 160, 132), (258, 256, 132),
                                        (1, 64, 132), (40, 512, 8)])
def test_bwd_plan_covers_every_chunk_with_nonempty_ranges(rows, d, sms):
    splits = fba.bwd_plan(rows, d, sms)
    chunks = -(-rows // fba.BWD_CHUNK)
    per = -(-chunks // splits)
    assert 1 <= splits <= min(fba.MAX_SPLITS, chunks)
    assert (splits - 1) * per < chunks <= splits * per      # no range empty, none left out


@pytest.mark.parametrize("rows,blocks", [(1, 1), (256, 1), (257, 2), (28_800, 113),
                                         (131_072, 512), (633_600, 512)])
def test_bwd_col_blocks(rows, blocks):
    """One slot of column sums per 256 rows, at most 512: a function of the
    rows alone, so the in-order sums repeat bit for bit."""
    assert fba.bwd_col_blocks(rows) == blocks


def test_bwd_scratch_sizes():
    """Stage 1 at B = 150 (N = 4,224, D = 64, one head, M = 192; 60 row
    ranges, 4 splits of N): LN1(x), s.dy, A and dQ 81 MB each, Q and dO
    162 MB (dLN1 in fp32 over them), the statistics and lse 5 and 2.5 MB,
    the attention backward's dK/dV slots 59 MB, the rest 2.5 MB: 0.56 GB.
    M above 192 adds the attention backward's fp32 dq sum; one range or
    split has no slots."""
    def nbytes(sizes):
        return {k: n * torch.empty(0, dtype=dt).element_size() for k, (n, dt) in sizes.items()}
    got = nbytes(fba.bwd_scratch(150, 4224, 64, 1, 192, 60, 4))
    assert got == {"nrm": 81_100_800, "dys": 81_100_800, "qdo": 162_201_600,
                   "attn": 81_100_800, "dq": 81_100_800, "st": 5_068_800, "lse": 2_534_400,
                   "colp": 524_288, "wslots": 1_966_080, "aslots": 58_982_400, "dq_acc": 0}
    assert sum(got.values()) == 555_680_768
    small = fba.bwd_scratch(2, 300, 96, 3, 600, 1, 1)
    assert small["wslots"][0] == small["aslots"][0] == 0
    assert small["dq_acc"] == (2 * 3 * 300 * 32, torch.float32)


def test_fwd_scratch_sizes():
    """The forward chain's scratch at stage 1, B = 150 (N = 4,224, D = 64,
    one head): LN1(x), Q and A 81 MB each, the attention core's lse 2.5 MB:
    0.25 GB, freed when the call returns. lse has a row per head."""
    got = {k: n * torch.empty(0, dtype=dt).element_size()
           for k, (n, dt) in fba.fwd_scratch(150, 4224, 64, 1).items()}
    assert got == {"nrm": 81_100_800, "q": 81_100_800, "attn": 81_100_800, "lse": 2_534_400}
    assert sum(got.values()) == 245_836_800
    assert fba.fwd_scratch(150, 192, 512, 8)["lse"] == (150 * 8 * 192, torch.float32)


@pytest.mark.parametrize("d,heads,ok", [(64, 1, True), (320, 5, True), (96, 3, True),
                                        (256, 16, False), (96, 2, False), (64, 3, False)])
def test_training_form_takes_head_dims_32_and_64(d, heads, ok):
    """The backward's attention core takes head dims 32 and 64; any other is
    refused by name before the forward launches."""
    if ok:
        fba.check_train_heads("x", d, heads)
    else:
        with pytest.raises(ValueError, match="head dims"):
            fba.check_train_heads("x", d, heads)
