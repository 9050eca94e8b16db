"""The plain versions of the port's PVT-v2 kernels against the Pallas kernels
they replace, and the v2 Block against the JAX package's.

block_attention_reference (mvlt_tpu_torch/ops/block_attention.py) and
dwconv_mlp_reference (mvlt_tpu_torch/ops/dwconv_mlp.py) are what kernels C
and D are held to on the card; here they are held to Pallas entries #9
(fused_block_attention_padded), #5 (fused_attention_p2, K/V from
fused_ln_sr_kv_p2), #16 (fused_dwconv_mlp) and #17 (fused_dwconv_mlp_p2),
run in interpret mode on the CPU with gelu="erf", at fp32 with rtol = atol =
1e-4 (the Pallas kernels take one-pass LayerNorm statistics and the A&S
erf). The port's v2 Block (eval, plain path) is held to JAX's v2 Block on its
XLA path at 2e-4. Weights reach the port through state_dict_from_jax; inputs
and weights are numpy draws from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import Block as TorchBlock
from mvlt_tpu_torch.ops.block_attention import block_attention_reference, fused_block_attention
from mvlt_tpu_torch.ops.dwconv_mlp import dwconv_mlp_reference, fused_dwconv_mlp
from mvlt_tpu_torch.ops.sr_kv import sr_kv_reference
from tests.kernel_utils import run_interpret

TOL = dict(rtol=1e-4, atol=1e-4)


def _fill(shapes, seed):
    """A flax parameter tree of the given shapes from a numpy seed: LayerNorm
    scales 1 + 0.1 N, everything else 0.1 N (biases carry signal)."""
    gen = np.random.default_rng(seed)

    def leaf(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * gen.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_block(dim, heads, sr, mlp_ratio):
    from mvlt_tpu.models.pvlt import Block

    return Block(dim=dim, num_heads=heads, mlp_ratio=mlp_ratio, sr_ratio=sr,
                 qkv_bias=True, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 ln_eps=1e-6, sr_ln_eps=1e-5, use_pallas=False, variant="v2",
                 dtype=jnp.float32)


def _block_params(dim, heads, sr, mlp_ratio, hw, t, seed):
    x = jnp.zeros((1, hw[0] * hw[1] + t, dim), jnp.float32)
    block = _jax_block(dim, heads, sr, mlp_ratio)
    shapes = jax.eval_shape(lambda key: block.init(key, x, hw, t), jax.random.PRNGKey(0))
    return _fill(shapes["params"], seed)


def _port_block(params, dim, heads, sr, mlp_ratio):
    """The port's v2 Block loaded strictly from the JAX params via the bridge."""
    sd = state_dict_from_jax({"block1_0": params})
    sd = {k[len("block1.0."):]: v for k, v in sd.items()}
    blk = TorchBlock(dim, heads, mlp_ratio, sr, True, v2=True).eval()
    blk.load_state_dict(sd, strict=True)
    return blk


def _pad(a, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


@pytest.mark.parametrize("n,dim,heads,m", [
    (80, 128, 2, 24),     # stage-2-like: lane-exact, two 64-wide heads
    (48, 320, 5, 20),     # stage-3-like: 320 -> 384 lanes, five heads
])
def test_block_attention_reference_matches_padded_pallas(n, dim, heads, m):
    """Pallas #9 on the lane-padded stream (K/V in its [B, H, 128k, 128]
    layout, kv_len = M) against the port's plain attention half."""
    from mvlt_tpu.ops.block_attention import fused_block_attention_padded

    rng = np.random.default_rng(11)
    hd, d_pad, m_pad = dim // heads, -(-dim // 128) * 128, -(-m // 128) * 128
    mk = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, heads, m, hd)).astype(np.float32)
    params = {"norm1": {"scale": 1.0 + mk(dim), "bias": mk(dim)},
              "attn": {"q": {"kernel": mk(dim, dim), "bias": mk(dim)},
                       "proj": {"kernel": mk(dim, dim), "bias": mk(dim)}}}
    p, a = params["norm1"], params["attn"]
    want = run_interpret(
        fused_block_attention_padded, jnp.asarray(_pad(x, (2, n, d_pad))),
        jnp.asarray(_pad(k, (2, heads, m_pad, 128))), jnp.asarray(_pad(v, (2, heads, m_pad, 128))),
        p["scale"], p["bias"], a["q"]["kernel"], a["q"]["bias"], a["proj"]["kernel"],
        a["proj"]["bias"], scale=hd ** -0.5, eps=1e-6, num_heads=heads, dim=dim, kv_len=m)
    want = np.asarray(want)
    assert np.all(want[..., dim:] == 0)           # pad lanes stay zero

    sd = state_dict_from_jax({"block1_0": params})
    g = lambda name: sd[f"block1.0.{name}"]
    got = block_attention_reference(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(v),
        g("norm1.weight"), g("norm1.bias"), g("attn.q.weight"), g("attn.q.bias"),
        g("attn.proj.weight"), g("attn.proj.bias"), heads=heads, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), want[..., :dim], **TOL)


def test_block_attention_reference_matches_packed_pallas():
    """Pallas #5 on the packed stage-1 stream [B, N/2, 128], with K/V from
    the packed SR-KV kernel (#3), against the port's plain SR-KV and
    attention half. Outputs are compared, not K/V: the packed text K/V rows
    come out even-tokens-first."""
    from mvlt_tpu.ops.block_packed import fused_attention_p2, fused_ln_sr_kv_p2

    dim, sr, hw, t = 64, 4, (8, 8), 12
    n = hw[0] * hw[1] + t
    params = _block_params(dim, 1, sr, 4.0, hw, t, seed=3)
    x = np.random.default_rng(4).standard_normal((2, n, dim)).astype(np.float32)
    xp = jnp.asarray(x).reshape(2, n // 2, 2 * dim)
    p, a = params, params["attn"]
    k, v, kv_len = run_interpret(
        fused_ln_sr_kv_p2, xp, p["norm1"]["scale"], p["norm1"]["bias"],
        a["sr"]["kernel"], a["sr"]["bias"], a["norm"]["scale"], a["norm"]["bias"],
        a["kv"]["kernel"], a["kv"]["bias"], dim=dim, hw=hw, t=t, sr=sr, heads=1,
        eps1=1e-6, eps_sr=1e-5)
    want = run_interpret(
        fused_attention_p2, xp, k, v, p["norm1"]["scale"], p["norm1"]["bias"],
        a["q"]["kernel"], a["q"]["bias"], a["proj"]["kernel"], a["proj"]["bias"],
        scale=dim ** -0.5, eps=1e-6, dim=dim, kv_len=kv_len)

    blk = _port_block(params, dim, 1, sr, 4.0)
    kv_args, attn_args, _ = blk.kernel_params()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        k_t, v_t = sr_kv_reference(xt, hw, *kv_args, **blk.kernel_kwargs()[0])
        got = block_attention_reference(xt, k_t, v_t, *attn_args, heads=1, eps=1e-6)
    assert k_t.shape[2] == kv_len
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, n, dim), **TOL)


def _mlp_params(rng, c, hid):
    mk = lambda *s, std=0.05: (std * rng.standard_normal(s)).astype(np.float32)
    return {"norm2": {"scale": 1.0 + mk(c, std=0.1), "bias": mk(c, std=0.1)},
            "mlp": {"fc1": {"kernel": mk(c, hid), "bias": mk(hid)},
                    "dwconv": {"kernel": mk(3, 3, 1, hid, std=0.2), "bias": mk(hid)},
                    "fc2": {"kernel": mk(hid, c), "bias": mk(c)}}}


def _dwconv_args(params):
    p, m = params["norm2"], params["mlp"]
    return (p["scale"], p["bias"], m["fc1"]["kernel"], m["fc1"]["bias"], m["dwconv"]["kernel"],
            m["dwconv"]["bias"], m["fc2"]["kernel"], m["fc2"]["bias"])


def _port_dwconv(x, hw, params):
    sd = state_dict_from_jax({"block1_0": params})
    g = lambda name: sd[f"block1.0.{name}"]
    return dwconv_mlp_reference(
        torch.from_numpy(x), hw, g("norm2.weight"), g("norm2.bias"), g("mlp.fc1.weight"),
        g("mlp.fc1.bias"), g("mlp.dwconv.dwconv.weight"), g("mlp.dwconv.dwconv.bias"),
        g("mlp.fc2.weight"), g("mlp.fc2.bias"), eps=1e-6).numpy()


@pytest.mark.parametrize("c,hid,hw,t", [
    (64, 512, (16, 16), 24),    # stage-1-like: lane-padded C, chunked hidden
    (128, 256, (8, 8), 8),      # exact lane width
    (96, 384, (8, 16), 16),     # non-128 C and hidden, h != w
])
def test_dwconv_mlp_reference_matches_pallas(c, hid, hw, t):
    """Pallas #16 (the shapes of tests/test_dwconv_mlp.py) against the
    port's plain DWConv-MLP half."""
    from mvlt_tpu.ops.dwconv_mlp import fused_dwconv_mlp

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, hw[0] * hw[1] + t, c)).astype(np.float32)
    params = _mlp_params(rng, c, hid)
    want = run_interpret(fused_dwconv_mlp, jnp.asarray(x), *_dwconv_args(params), hw=hw,
                         eps=1e-6, gelu="erf")
    np.testing.assert_allclose(_port_dwconv(x, hw, params), np.asarray(want), **TOL)


def test_dwconv_mlp_reference_matches_packed_pallas():
    """Pallas #17 on the packed stage-1 stream (dim 64, the conv's halo
    crossing the lane halves) against the port's plain DWConv-MLP half."""
    from mvlt_tpu.ops.dwconv_mlp import fused_dwconv_mlp_p2

    c, hid, hw, t = 64, 256, (8, 16), 16
    n = hw[0] * hw[1] + t
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    params = _mlp_params(rng, c, hid)
    want = run_interpret(fused_dwconv_mlp_p2, jnp.asarray(x).reshape(2, n // 2, 2 * c),
                         *_dwconv_args(params), hw=hw, eps=1e-6, gelu="erf", dim=c)
    np.testing.assert_allclose(_port_dwconv(x, hw, params),
                               np.asarray(want).reshape(2, n, c), **TOL)


@pytest.mark.parametrize("dim,heads,sr,mlp_ratio,hw,t", [
    (64, 1, 4, 8.0, (8, 8), 12),     # stage-1-like, one head
    (96, 3, 2, 4.0, (6, 10), 7),     # h != w, odd text count, head dim 32
    (128, 2, 1, 4.0, (4, 4), 8),     # sr == 1
])
def test_v2_block_matches_jax(dim, heads, sr, mlp_ratio, hw, t):
    """The port's v2 Block in eval mode (the serving wrappers on CPU tensors:
    their plain versions) against JAX's v2 Block on its XLA path
    (JointSRAttention + DWConvMlp), at fp32."""
    params = _block_params(dim, heads, sr, mlp_ratio, hw, t, seed=dim)
    x = np.random.default_rng(t).standard_normal((2, hw[0] * hw[1] + t, dim)).astype(np.float32)
    block = _jax_block(dim, heads, sr, mlp_ratio)
    want = jax.jit(lambda p, x: block.apply({"params": p}, x, hw, t))(params, jnp.asarray(x))
    blk = _port_block(params, dim, heads, sr, mlp_ratio)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_v2_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Off the CPU a wrapper launches its kernel or raises: it never falls
    back to the plain version; on the CPU no launch is counted."""
    blk = TorchBlock(64, 1, 4.0, 2, True, v2=True).eval()
    _, attn_args, mlp_args = blk.kernel_params()
    x = torch.empty(1, 16 + 4, 64, device="meta")
    k = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_block_attention(x, k, k, *attn_args, heads=1, eps=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        fused_dwconv_mlp(x, (4, 4), *mlp_args, eps=1e-6)
    launches = (fused_block_attention.launches, fused_dwconv_mlp.launches)
    with torch.no_grad():
        blk(torch.randn(1, 20, 64), (4, 4))
    assert (fused_block_attention.launches, fused_dwconv_mlp.launches) == launches
