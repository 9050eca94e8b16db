"""The port's plain kernel references against the JAX package's Pallas kernels.

sr_kv_reference (mvlt_tpu_torch/ops/sr_kv.py) and block_reference
(mvlt_tpu_torch/ops/block_fused.py) are what the Hopper kernels are held to
on the card; here they are held to the Pallas kernels they replace, run in
interpret mode on the CPU, at fp32 with rtol = atol = 1e-4 (the JAX kernels
use one-pass LayerNorm statistics and, for gelu="erf", the A&S erf with abs
error 1.5e-7). Weights reach the port through state_dict_from_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import Block as TorchBlock
from mvlt_tpu_torch.ops.block_fused import block_reference, fused_block
from mvlt_tpu_torch.ops.block_fused import scratch as block_scratch
from mvlt_tpu_torch.ops.fused_mlp import ln_mlp_bwd, ln_mlp_fwd
from mvlt_tpu_torch.ops.pallas_attention import attention_bwd, attention_fwd
from mvlt_tpu_torch.ops.sr_kv import fused_ln_sr_kv, sr_kv_reference
from tests.kernel_utils import run_interpret
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_block(dim, heads, sr, mlp_ratio=4.0, **kw):
    from mvlt_tpu.models.pvlt import Block

    return Block(dim=dim, num_heads=heads, mlp_ratio=mlp_ratio, sr_ratio=sr,
                 qkv_bias=True, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 ln_eps=1e-6, sr_ln_eps=1e-5, use_pallas=False,
                 dtype=jnp.float32, **kw)


def _perturbed_block(block, x, hw, t, seed):
    """JAX Block params with every leaf perturbed (zero biases carry signal)."""
    variables = block.init(jax.random.PRNGKey(0), x, hw, t)
    gen = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.03 * gen.standard_normal(np.shape(a))
                   ).astype(np.float32), variables["params"])


def _port_block(params, dim, heads, sr, mlp_ratio=4.0):
    """The port's Block loaded strictly from the JAX params via the bridge."""
    sd = state_dict_from_jax({"block1_0": params})
    sd = {k[len("block1.0."):]: v for k, v in sd.items()}
    blk = TorchBlock(dim, heads, mlp_ratio, sr, True).eval()
    blk.load_state_dict(sd, strict=True)
    return blk


def _kv_args(blk):
    return blk.kernel_params()[0]


def _block_args(blk):
    return blk.kernel_params()[1]


@pytest.mark.parametrize("dim,heads,sr,hw,t", [
    (64, 1, 8, (16, 16), 12),     # stage-1-like
    (320, 5, 2, (8, 8), 12),      # stage-3-like, multi-head
    (128, 2, 1, (8, 8), 12),      # stage-4-like, sr == 1
])
def test_sr_kv_reference_matches_pallas(dim, heads, sr, hw, t):
    from mvlt_tpu.models.pvlt import Block

    rng = np.random.default_rng(1)
    h, w = hw
    x = rng.normal(size=(2, h * w + t, dim)).astype(np.float32)
    block = _jax_block(dim, heads, sr)
    params = _perturbed_block(block, jnp.asarray(x), hw, t, seed=2)
    d_pad = -(-dim // 128) * 128
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, d_pad - dim)))
    k_j, v_j, m = run_interpret(block.apply, {"params": params}, xp, hw,
                                method=Block._sr_kv)

    blk = _port_block(params, dim, heads, sr)
    with torch.no_grad():
        k, v = sr_kv_reference(torch.from_numpy(x), hw, *_kv_args(blk), sr=sr,
                               heads=heads, eps1=1e-6, eps_sr=1e-5)
    hd = dim // heads
    assert k.shape == (2, heads, m, hd)
    # the Pallas layout pads M to 128 rows (bias-valued) and hd to 128 lanes
    np.testing.assert_allclose(k.numpy(), np.asarray(k_j)[:, :, :m, :hd], **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j)[:, :, :m, :hd], **TOL)


@pytest.mark.parametrize("n,d,h,m,hidden", [
    (96, 64, 1, 24, 512),      # stage-1-like, mlp x8
    (48, 128, 2, 24, 256),
    (32, 320, 5, 20, 640),     # stage-3-like
])
def test_block_reference_matches_pallas(n, d, h, m, hidden):
    from mvlt_tpu.ops.block_fused import fused_block as jax_fused_block

    rng = np.random.default_rng(7)
    hd = d // h
    mk = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    k, v = mk(2, h, m, hd), mk(2, h, m, hd)
    params = {
        "norm1": {"scale": mk(d) + 1.0, "bias": mk(d)},
        "attn": {"q": {"kernel": mk(d, d), "bias": mk(d)},
                 "proj": {"kernel": mk(d, d), "bias": mk(d)}},
        "norm2": {"scale": mk(d) + 1.0, "bias": mk(d)},
        "mlp": {"fc1": {"kernel": mk(d, hidden), "bias": mk(hidden)},
                "fc2": {"kernel": mk(hidden, d), "bias": mk(d)}},
    }
    p = params
    want = run_interpret(
        jax_fused_block, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
        p["norm1"]["scale"], p["norm1"]["bias"],
        p["attn"]["q"]["kernel"], p["attn"]["q"]["bias"],
        p["attn"]["proj"]["kernel"], p["attn"]["proj"]["bias"],
        p["norm2"]["scale"], p["norm2"]["bias"],
        p["mlp"]["fc1"]["kernel"], p["mlp"]["fc1"]["bias"],
        p["mlp"]["fc2"]["kernel"], p["mlp"]["fc2"]["bias"],
        scale=hd ** -0.5, eps1=1e-6, eps2=1e-6, num_heads=h, gelu="erf")

    sd = state_dict_from_jax({"block1_0": params})
    g = lambda name: sd[f"block1.0.{name}"]
    got = block_reference(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(v),
        g("norm1.weight"), g("norm1.bias"), g("attn.q.weight"), g("attn.q.bias"),
        g("attn.proj.weight"), g("attn.proj.bias"), g("norm2.weight"),
        g("norm2.bias"), g("mlp.fc1.weight"), g("mlp.fc1.bias"),
        g("mlp.fc2.weight"), g("mlp.fc2.bias"), heads=h, eps1=1e-6, eps2=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stage1_packed_block_matches_pallas():
    """The stage-1 packed Pallas path (fused_ln_sr_kv_p2 + fused_block_p2)
    against the port's plain SR-KV + block. The block output is compared:
    the packed text K/V rows come out even-tokens-first."""
    from mvlt_tpu.models.pvlt import Block

    dim, heads, sr, hw, t = 64, 1, 8, (16, 16), 12
    h, w = hw
    n = h * w + t
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, n, dim)).astype(np.float32)
    block = _jax_block(dim, heads, sr, mlp_ratio=8.0, kernel_gelu="erf")
    params = _perturbed_block(block, jnp.asarray(x), hw, t, seed=4)
    want = run_interpret(block.apply, {"params": params},
                         jnp.asarray(x).reshape(2, n // 2, 2 * dim), hw, t,
                         method=Block._fused_full_block_p2)

    blk = _port_block(params, dim, heads, sr, mlp_ratio=8.0)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        k, v = sr_kv_reference(xt, hw, *_kv_args(blk), sr=sr, heads=heads,
                               eps1=1e-6, eps_sr=1e-5)
        got = block_reference(xt, k, v, *_block_args(blk), heads=heads,
                              eps1=1e-6, eps2=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, n, dim), **TOL)


@pytest.mark.parametrize("sr", [4, 1])
def test_module_path_matches_kernel_references(sr):
    """Block on a CPU tensor is the kernels' plain versions on its
    parameters, in fp32 and in bf16, with no launch counted; its cached
    operands follow load_state_dict."""
    dim, heads, hw, t = 128, 2, (8, 8), 12
    gen = torch.Generator().manual_seed(5)
    blk = TorchBlock(dim, heads, 4.0, sr, True).eval()
    with torch.no_grad():
        for prm in blk.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
        x = torch.randn(2, hw[0] * hw[1] + t, dim, generator=gen)
        for xd in (x, x.to(torch.bfloat16)):
            launches = (fused_ln_sr_kv.launches, fused_block.launches)
            got = blk(xd, hw)
            k, v = sr_kv_reference(xd, hw, *_kv_args(blk), sr=sr, heads=heads,
                                   eps1=1e-6, eps_sr=1e-5)
            want = block_reference(xd, k, v, *_block_args(blk), heads=heads,
                                   eps1=1e-6, eps2=1e-6)
            assert (fused_ln_sr_kv.launches, fused_block.launches) == launches
            assert got.dtype == xd.dtype
            np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                       rtol=1e-5, atol=1e-5)
        other = TorchBlock(dim, heads, 4.0, sr, True).eval()
        blk.load_state_dict(other.state_dict())
        np.testing.assert_array_equal(blk(x, hw).numpy(), other(x, hw).numpy())


def test_block_scratch_sizes():
    """Kernel B's chain's scratch at stage 1, B = 101 (N = 4,224, D = 64,
    one head, hidden 512): LN1(x) (then LN2(h)), Q, A and h 54.6 MB each,
    lse 1.7 MB, no hidden (the MLP is one launch at D <= 128): 0.22 GB.
    At stage 3 (D = 320, hidden 1,280) #12's three launches add G."""
    got = {k: n * torch.empty(0, dtype=dt).element_size()
           for k, (n, dt) in block_scratch(101, 4224, 64, 1, 512).items()}
    assert got == {"nrm": 54_607_872, "q": 54_607_872, "attn": 54_607_872, "h": 54_607_872,
                   "g": 0, "lse": 1_706_496}
    assert sum(got.values()) == 220_137_984
    assert block_scratch(101, 384, 320, 5, 1280)["g"] == (49_643_520, torch.bfloat16)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Off the CPU a wrapper launches its kernel or raises: it never falls
    back to the plain version. The same holds for the training kernels."""
    blk = TorchBlock(64, 1, 4.0, 2, True).eval()
    x = torch.empty(1, 16 + 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ln_sr_kv(x, (4, 4), *_kv_args(blk), sr=2, heads=1, eps1=1e-6,
                       eps_sr=1e-5)
    k = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_block(x, k, k, *_block_args(blk), heads=1, eps1=1e-6, eps2=1e-6)
    # the training path's kernels refuse them too
    q = torch.empty(1, 1, 20, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_fwd(q, k, k, 0.125)
    lse = torch.empty(1, 1, 20, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_bwd(q, k, k, q, lse, q, 0.125)
    mlp = (blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
           blk.mlp.fc2.weight)
    with pytest.raises(ValueError, match="CUDA"):
        ln_mlp_fwd(x, *mlp, blk.mlp.fc2.bias, torch.ones(1), 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        ln_mlp_bwd(x, *mlp, torch.ones(1), 1e-6, x)
