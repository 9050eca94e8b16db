"""PVLT, the Pyramid Vision-Language Transformer, in PyTorch (v1, v2 and
Swin backbones).

Counterpart of mvlt_tpu/models/pvlt.py: a 4-stage PVT pyramid whose stages
each re-project the BERT text tokens and concatenate them with the image
patch tokens, attend jointly with spatial-reduction attention on the visual
K/V only, and split the stream back. Parameters carry the reference's torch
state-dict names (mvlt_tpu/convert/torch_to_jax.py:_MAPPING), so a state dict
exported from the JAX package or a published ``.pth`` loads with
``strict=True``. Reference quirks kept: built at ``img_size`` 224 and run at
256 through a bilinear pos-embed resize; the stage-4 pos-embed has one extra
slot, dropped at use; NHWC images in (NCHW accepted). The v2 backbone
(PVT-v2) embeds patches with overlapping convs (k7 s4, then k3 s2) and runs
the DWConv MLP (fc1 -> 3x3 depthwise conv on the visual rows -> GELU -> fc2);
its conv-SR attention is v1's, and with ``linear_sr`` (pvlt_v2_linear_tiny)
the stages that reduce pool the visual rows (floored windows to at most
7x7), then a 1x1 conv, SR-LN and GELU. The Swin backbone embeds patches as
v1 and attends in (shifted on every odd block) windows plus all text tokens
(models/swin.py); a Swin model is built for the input size it runs at, since
its relative-position tables take their shape from the stages' grids.

Parameters stay fp32; with ``compute_dtype="bfloat16"`` the stream and the
matrix-product operands are bf16 and LayerNorm statistics and softmax fp32.
A block has two paths, each the plain PyTorch versions on a CPU tensor and
Hopper kernels and nothing else in their place on a CUDA tensor:
  * serving, in eval mode when no gradient is wanted: ops/sr_kv.py then
    ops/block_fused.py (v1), or ops/sr_kv.py, ops/block_attention.py and
    ops/dwconv_mlp.py (v2; with linear SR the K/V front end and projection
    in PyTorch in place of ops/sr_kv.py), on bf16 operands cast once and
    detached;
  * Swin serving, in eval mode when no gradient is wanted: on a stage
    ``swin_band_stage`` admits, ops/swin_band.py (kernel E) for the visual
    rows' whole block, their text rows in PyTorch; elsewhere SwinJointAttention
    with ops/swin_attention.py (kernel F) and the LN-MLP of ops/fused_mlp.py;
  * training, whenever a gradient is wanted or in training mode, with the
    routes of the JAX package's Block (mvlt_tpu/models/pvlt.py:858-991):
    the projections and the K/V front end in PyTorch, the attention core of
    ops/pallas_attention.py (v1, v2), and the LN-MLP of ops/fused_mlp.py
    (v1, Swin), both differentiable, with DropPath (training mode only) as
    per-sample scales. v2's DWConv MLP is PyTorch glue, as is Swin's window
    attention (swin.py:window_attention); with ``drop_rate`` the MLP of v1
    and Swin is glue too, and with ``attn_drop_rate`` the attention core
    (``attention_dropout``), since no kernel takes a dropout mask. With
    ``fused_attn_train`` in training mode a v1 block without dropout keeps
    its K/V projection in PyTorch and runs the rest of the attention half
    (LN1, Q, attention, the out-projection and the DropPath add) as one call
    of ops/block_attention.py:fused_block_attention_train
    (``fused_attn_stats``: its saved-statistics backward). With ``remat``
    each block runs under torch.utils.checkpoint (``checkpoint_block``).
Under tensor parallelism (parallel/tensor.py:shard_model) every block of a
split model takes the training route in eval mode too, under no_grad:
#10/#11 on the rank's heads (v1, v2), Swin's window attention glue on the
rank's heads and bias-table columns, the LN-MLP kernels in their
tensor-parallel modes (v1, Swin), v2's DWConv MLP glue on the rank's hidden
channels, and with dropout the glue on the same splits, each split
tensor's mask the rank's slice of the one-process mask. The serving
kernels A-F fuse the out-projection, the residual, LN2 and the MLP across
what is there a sum over ranks, so a shard never runs them; they stay for
the unsharded model.
Under sequence parallelism (``create_model(..., sp_group=)``, every
backbone; parallel/sequence.py) each stage that ``row_plan`` splits runs
its blocks on the rank's band of grid rows and slice of text rows: the
serving kernels A and B, or A, C and D, on the band (A's K/V rows, or
linear SR's pooled sums, gathered whole; D with a halo row from each
neighbour), Swin's window path (kernel F on the band's windows, the
shifted ones taking rows from the next band, then the LN-MLP forward; kernel E
serves only the stages left whole, as the JAX package's gate keeps its
band kernel off under ``sp_mesh``), the training route the same way; the
stream is gathered whole at the stage's end and the heads run replicated.
With tensor-parallel weights as well (``shard_model`` over the same
group) the stream holds the band between the blocks, each split half
gathers its LN'd band whole and reduce-scatters its partials back to the
band (parallel/tensor.py).
The training forward returns the MLM head's transformed hidden rows, the
tied table and the bias (``mlm_hidden``, ``mlm_table``, ``mlm_bias``, and
``mlm_vocab_group``: the model group of a split vocabulary, else None) in
place of the [B, T, vocab] logits, for the chunked loss; eval returns all
five logits.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.optim.optimizer import register_optimizer_step_post_hook
from torch.utils.checkpoint import checkpoint

from mvlt_tpu_torch.config import DataConfig, ModelConfig
from mvlt_tpu_torch.models.bert_embeddings import BertEmbeddings, dropout
from mvlt_tpu_torch.models.heads import CLSHead, ITGHead, ITMHead, MLMHead
from mvlt_tpu_torch.models.registry import resolve_model_config, validate_model_config
from mvlt_tpu_torch.models.swin import (TEXT_POOL, SwinJointAttention, heads_of, merge_heads,
                                        swin_band_stage, window_size_for)
from mvlt_tpu_torch.ops.block_attention import (fused_block_attention,
                                                fused_block_attention_train)
from mvlt_tpu_torch.ops.block_fused import fused_block
from mvlt_tpu_torch.ops.dwconv_mlp import fused_dwconv_mlp
from mvlt_tpu_torch.ops.fused_mlp import fused_ln_mlp
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, gelu, layer_norm_fp32, linear, softmax_av
from mvlt_tpu_torch.ops.pallas_attention import fused_attention
from mvlt_tpu_torch.ops.sr_kv import (fused_ln_sr_kv, linear_pool_shape, linear_reduce_kv_input,
                                      linear_sr_rows, reduce_kv_input, split_kv)
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention
from mvlt_tpu_torch.ops.swin_band import fused_swin_block
from mvlt_tpu_torch.ops.upsample import resize_bilinear
from mvlt_tpu_torch.parallel import sequence
from mvlt_tpu_torch.parallel.tensor import (copy_to_model, fused_attn_tp, fused_ln_mlp_tp,
                                            model_input, row_parallel_linear, split_dim)


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return layer_norm_fp32(x, norm.weight, norm.bias, norm.eps)


def _embed(x: torch.Tensor, conv: nn.Conv2d, norm: nn.LayerNorm):
    """conv then LayerNorm: NHWC [B, H, W, C_in] -> (tokens [B, gh*gw, D] in
    row-major (y, x), (gh, gw))."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 stride=conv.stride, padding=conv.padding)
    gh, gw = y.shape[-2:]
    return _ln(y.flatten(2).transpose(1, 2), norm), (gh, gw)


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding + LayerNorm:
    NHWC [B, H, W, C_in] -> tokens [B, (H/p)(W/p), D] in row-major (y, x)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=ln_eps)

    def forward(self, x: torch.Tensor):
        _, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch size {p}")
        return _embed(x, self.proj, self.norm)


class OverlapPatchEmbed(nn.Module):
    """PVT-v2 overlapping patch embedding: a conv with kernel > stride and
    padding kernel // 2, then LayerNorm; NHWC in, tokens out as
    ``PatchEmbed``."""

    def __init__(self, kernel: int, stride: int, in_chans: int, embed_dim: int,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel, stride=stride, padding=kernel // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=ln_eps)

    def forward(self, x: torch.Tensor):
        return _embed(x, self.proj, self.norm)


class JointSRAttention(nn.Module):
    """Parameters of the joint image+text attention with spatial reduction on
    the visual K/V: queries from all N rows, K/V from
    [SR-LN(SRconv(visual)) ; text]. With ``linear_sr`` (PVT-v2's linear SR)
    ``sr`` is a 1x1 conv after a floored average pool and SR-LN is followed
    by GELU (ops/sr_kv.py:linear_reduce_kv_input). ``Block`` computes it on
    one of its two paths."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = False, ln_eps: float = 1e-5, linear_sr: bool = False):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.linear_sr = linear_sr
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if linear_sr or sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, 1 if linear_sr else sr_ratio,
                                stride=1 if linear_sr else sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=ln_eps)


class Mlp(nn.Module):
    """Parameters of Linear -> exact-erf GELU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class DWConv(nn.Module):
    """Parameters of PVT-v2's 3x3 depthwise conv (``dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)


class DWConvMlp(nn.Module):
    """Parameters of PVT-v2's MLP: fc1 -> depthwise 3x3 conv over the visual
    rows -> exact-erf GELU -> fc2 (ops/dwconv_mlp.py computes it)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)


def kernel_operand(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A parameter as the wrappers take it: matrices in the compute dtype (a
    conv weight channels-last: for the SR conv the [out, (r, s, in)] layout
    kernel A reads, for the depthwise conv the [hidden, 9] taps kernel D
    reads), vectors fp32 as they are."""
    if t is None or t.dim() == 1:
        return t
    t = t.detach()
    if t.dim() == 4:
        return t.to(dtype, memory_format=torch.channels_last)
    return t.to(dtype)


# Optimizer steps taken in this process, by any torch optimizer: a fused
# update (AdamW(fused=True)) writes the parameters without moving their
# ``_version``, so the serving caches read this count too.
_optimizer_steps = 0


def _count_optimizer_step(optimizer, args, kwargs) -> None:
    global _optimizer_steps
    _optimizer_steps += 1


register_optimizer_step_post_hook(_count_optimizer_step)


class CastOperands:
    """The cache of a block's serving operands: ``kernel_params`` cast by
    ``kernel_operand``, and tables made from them (``kernel_table``)."""

    _operands = None

    def kernel_operands(self, dtype: torch.dtype) -> tuple[tuple, ...]:
        """``kernel_params`` cast by ``kernel_operand`` once, and again only
        after a parameter changed in place (load_state_dict, an in-place
        edit), moved, or the compute dtype changed, or after any optimizer
        step (fused or not). A write through ``.data`` outside an optimizer
        step moves none of these and is not seen."""
        stamp = (dtype, _optimizer_steps,
                 *((p.device, p.data_ptr(), p._version) for p in self.parameters()))
        if self._operands is None or self._operands[0] != stamp:
            self._operands = (stamp, tuple(tuple(kernel_operand(t, dtype) for t in group)
                                           for group in self.kernel_params()), {})
        return self._operands[1]

    def kernel_table(self, dtype: torch.dtype, key, make):
        """``make()``, made once per ``key`` beside the operands cast to
        ``dtype`` and again whenever they are re-cast."""
        self.kernel_operands(dtype)
        tables = self._operands[2]
        if key not in tables:
            tables[key] = make()
        return tables[key]

    def _apply(self, fn, *args, **kwargs):
        self._operands = None
        return super()._apply(fn, *args, **kwargs)

    def wants_grad(self, *xs: torch.Tensor) -> bool:
        """Whether autograd would want a gradient through the block."""
        return torch.is_grad_enabled() and (
            any(x.requires_grad for x in xs) or any(p.requires_grad for p in self.parameters()))


def _add_scaled(x: torch.Tensor, out: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x + s * out with the per-sample DropPath scale s [B] (None: 1)."""
    return x + (out if scale is None else out * scale.to(x.dtype)[:, None, None])


def attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      rate: float, generator: Optional[torch.Generator],
                      split: Optional[tuple] = None, rows: Optional[tuple] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with dropout on the probabilities, the masks
    from ``generator``: fp32 logits and softmax, the dropped probabilities
    rounded to v.dtype, an fp32 P.V sum, q.dtype out. Counterpart of
    mvlt_tpu/models/pvlt.py:227-239, which materialises the probabilities in
    XLA and never in a kernel; so does this. ``split``: the rank's heads of
    a split attention, ``rows``: a sequence-parallel rank's query rows
    (``dropout``'s)."""
    acc = acc_dtype(q.dtype)
    probs = torch.softmax(torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale, dim=-1)
    probs = dropout(probs, rate, generator, split, rows).to(v.dtype)
    return torch.matmul(probs.to(acc), v.to(acc)).to(q.dtype)


class BlockGlue(CastOperands):
    """What the two block classes share on the training path: the DropPath
    draw, dropout, and the LN-MLP half. ``drop_path`` and ``drop`` are the
    block's rates; every mask comes from the step's ``generator`` and only
    in training mode. Under tensor parallelism (``tp_group`` set by
    parallel/tensor.py:shard_model) the attention holds the rank's whole
    heads where ``attn_split`` and the MLP its slice of the hidden where
    ``mlp_split``. Under sequence parallelism the block's methods take the
    stage's row plan ``sp`` (parallel/sequence.py:RowPlan) and the stream
    holds the rank's rows; a mask of such a tensor is the rank's rows of the
    one-process mask."""

    drop_path = 0.0
    drop = 0.0
    tp_group = None      # the model group under tensor parallelism
    attn_split = False   # the attention's heads split over it
    mlp_split = False    # the MLP hidden split over it

    def drop_path_scale(self, x: torch.Tensor,
                        generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """Per-sample stochastic-depth scale [B] fp32 (Bernoulli(keep) /
        keep) in training mode, None where DropPath is off."""
        if not self.training or self.drop_path == 0.0:
            return None
        keep = 1.0 - self.drop_path
        mask = torch.rand(x.shape[0], generator=generator, device=x.device) < keep
        return mask.float() / keep

    def dropout(self, t: torch.Tensor, generator: Optional[torch.Generator],
                split: Optional[tuple] = None, sp=None) -> torch.Tensor:
        """Dropout at the block's ``drop`` in training mode; else ``t``.
        ``split``: t is a rank's slice (``dropout``'s); ``sp``: t [B, rows,
        ...] holds the rows of the row plan ``sp``."""
        if not (self.training and self.drop):
            return t
        return dropout(t, self.drop, generator, split, None if sp is None else (1, sp))

    def mlp_hidden_in(self, x: torch.Tensor, sp=None) -> tuple:
        """(LN2 x, the model group the hidden is split over or None): with
        ``mlp_split`` LN2's output enters fc1 through ``model_input``
        (``copy_to_model``, or with ``sp`` the band gathered whole)."""
        normed = _ln(x, self.norm2)
        group = self.tp_group if self.mlp_split else None
        return (normed if group is None else model_input(normed, group, sp)), group

    def mlp_half(self, x: torch.Tensor, generator: Optional[torch.Generator],
                 ln_mlp=fused_ln_mlp, sp=None) -> torch.Tensor:
        """x + s2 mlp(LN2 x) of the plain MLP: ``ln_mlp`` (the LN-MLP kernels'
        wrapper; a check passes its plain version) with DropPath as its row
        scale; with ``drop`` > 0 PyTorch glue with dropout after GELU and
        after fc2, since the JAX package's kernel takes no dropout
        (mvlt_tpu/models/pvlt.py:925-930, :287-296). With ``mlp_split``
        parallel/tensor.py:fused_ln_mlp_tp over the rank's hidden slice, or
        with ``drop`` the glue on it: the hidden's mask the rank's slice,
        fc2's partials summed before its bias, the output's mask whole.
        ``sp``: x holds the rows of that row plan (every mask its rows');
        with ``mlp_split`` too the hidden covers the whole stream, gathered
        from the bands, and fc2's partials are reduce-scattered to the band."""
        m = self.mlp
        if self.drop:
            normed, group = self.mlp_hidden_in(x, sp)
            hidden = gelu(linear(normed, m.fc1.weight, m.fc1.bias))
            hidden = self.dropout(hidden, generator, split_dim(group, -1),
                                  sp if group is None else None)
            out = row_parallel_linear(hidden, m.fc2.weight, m.fc2.bias, group, sp)
            return _add_scaled(x, self.dropout(out, generator, sp=sp),
                               self.drop_path_scale(x, generator))
        if self.mlp_split:
            return fused_ln_mlp_tp(x, self.norm2.weight, self.norm2.bias, m.fc1.weight,
                                   m.fc1.bias, m.fc2.weight, m.fc2.bias,
                                   self.drop_path_scale(x, generator), self.norm2.eps,
                                   self.tp_group, sp)
        return ln_mlp(x, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                      m.fc2.weight, m.fc2.bias, self.drop_path_scale(x, generator),
                      self.norm2.eps)


class Block(BlockGlue, nn.Module):
    """Pre-LN block: x + s1 attn(LN1 x), then + s2 mlp(LN2 .), where s1, s2
    are per-sample DropPath scales (mask / keep) in training mode and 1 in
    eval; ``mlp`` is the DWConv MLP for ``v2``. Serving path or training path
    as the module docstring says; ``drop`` and ``attn_drop`` are the dropout
    rates of the projections and MLP and of the attention probabilities."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, sr_ratio: int,
                 qkv_bias: bool, ln_eps: float = 1e-6, sr_ln_eps: float = 1e-5,
                 drop_path: float = 0.0, v2: bool = False, fused_attn_train: bool = False,
                 fused_attn_stats: bool = False, linear_sr: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.drop_path = drop_path
        self.drop = drop
        self.attn_drop = attn_drop
        self.v2 = v2
        self.fused_attn_train = fused_attn_train
        self.fused_attn_stats = fused_attn_stats
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = JointSRAttention(dim, num_heads, sr_ratio, qkv_bias, sr_ln_eps, linear_sr)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = (DWConvMlp if v2 else Mlp)(dim, int(dim * mlp_ratio))

    def kernel_params(self) -> tuple[tuple, ...]:
        """The parameters in the argument order of the serving wrappers: v1
        ``fused_ln_sr_kv`` and ``fused_block``; v2 ``fused_ln_sr_kv``,
        ``fused_block_attention`` and ``fused_dwconv_mlp``. The SR ones are
        None at sr == 1; with linear SR the first group feeds the K/V front
        end in PyTorch (``kv_input``) in place of kernel A."""
        a, m = self.attn, self.mlp
        sr = ((a.sr.weight, a.sr.bias, a.norm.weight, a.norm.bias)
              if a.sr_ratio > 1 else (None,) * 4)
        kv = (self.norm1.weight, self.norm1.bias, *sr, a.kv.weight, a.kv.bias)
        attn = (self.norm1.weight, self.norm1.bias, a.q.weight, a.q.bias,
                a.proj.weight, a.proj.bias)
        if self.v2:
            dw = m.dwconv.dwconv
            return kv, attn, (self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                              dw.weight, dw.bias, m.fc2.weight, m.fc2.bias)
        return kv, (*attn, self.norm2.weight, self.norm2.bias,
                    m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)

    def kernel_kwargs(self) -> tuple[dict, ...]:
        """The keyword arguments of the wrappers, in ``kernel_params``'s order."""
        a = self.attn
        kv = dict(sr=a.sr_ratio, heads=self.num_heads, eps1=self.norm1.eps,
                  eps_sr=a.norm.eps if a.sr_ratio > 1 else 1e-5)
        if self.v2:
            return kv, dict(heads=self.num_heads, eps=self.norm1.eps), dict(eps=self.norm2.eps)
        return kv, dict(heads=self.num_heads, eps1=self.norm1.eps, eps2=self.norm2.eps)

    def kv_input(self, normed: torch.Tensor, hw: tuple, sr_weight, sr_bias, srn_weight,
                 srn_bias, sp=None) -> torch.Tensor:
        """The K/V input from the LN1'd stream: the linear SR front end, or
        the conv SR one (the stream itself at sr == 1). Under sequence
        parallelism (``sp``, the stage's row plan; ``normed`` the band's
        rows, ``hw`` its grid) the whole K/V input, in the one-process
        order: conv SR reduces the band and gathers the rows
        (sequence.gather_kv); linear SR pools the whole grid from every
        band's share of each window (sequence.linear_pool), runs the rest of
        its front end replicated and gathers the text rows."""
        a = self.attn
        if a.linear_sr:
            if sp is None:
                return linear_reduce_kv_input(normed, hw, sr_weight, sr_bias, srn_weight,
                                              srn_bias, a.norm.eps)
            b, _, d = normed.shape
            hb, w = hw
            win, out = linear_pool_shape((sp.h, sp.w))
            pooled = sequence.linear_pool(normed[:, :hb * w].reshape(b, hb, w, d), sp, win, out)
            red = linear_sr_rows(pooled.permute(0, 3, 1, 2), sr_weight, sr_bias, srn_weight,
                                 srn_bias, a.norm.eps)
            return torch.cat([red, sequence.gather_kv(normed[:, hb * w:], sp, 0, dim=1)], 1)
        kv_in = reduce_kv_input(normed, hw, a.sr_ratio, sr_weight, sr_bias, srn_weight,
                                srn_bias, a.norm.eps if a.sr_ratio > 1 else 1e-5)
        if sp is None:
            return kv_in
        return sequence.gather_kv(kv_in, sp, sequence.kv_visual_rows(sp, a.sr_ratio), dim=1)

    def linear_sr_kv(self, x: torch.Tensor, hw: tuple, ln1_weight, ln1_bias, sr_weight,
                     sr_bias, srn_weight, srn_bias, kv_weight, kv_bias, sp=None):
        """K, V [B, heads, M, hd], contiguous, of a linear-SR block on the
        given parameters (``kernel_params``'s first group, or its cast
        operands): LN1, ``kv_input`` and the K/V projection in PyTorch,
        where kernel A runs for conv SR; ``sp``: the whole K/V from the
        band's rows."""
        normed = layer_norm_fp32(x, ln1_weight, ln1_bias, self.norm1.eps)
        kv_in = self.kv_input(normed, hw, sr_weight, sr_bias, srn_weight, srn_bias, sp)
        k, v = split_kv(linear(kv_in, kv_weight, kv_bias), self.num_heads)
        return k.contiguous(), v.contiguous()

    def forward(self, x: torch.Tensor, hw: tuple,
                generator: Optional[torch.Generator] = None, sp=None) -> torch.Tensor:
        """The block on the stream x [B, h*w + T, D] of the grid ``hw``. Under
        sequence parallelism x holds the rank's rows of the row plan ``sp``
        and ``hw`` is its band's grid: kernel A gives the band's K/V rows,
        gathered whole (sequence.gather_kv), and B, or C and D, run on the
        band, D with one halo grid row from each neighbour
        (sequence.exchange_halo), whose output rows are dropped."""
        if self.training or self.wants_grad(x) or self.tp_group is not None:
            return self.train_forward(x, hw, generator, sp=sp)
        ops, kws = self.kernel_operands(x.dtype), self.kernel_kwargs()
        if self.attn.linear_sr:
            k, v = self.linear_sr_kv(x, hw, *ops[0], sp=sp)
        else:
            k, v = fused_ln_sr_kv(x, hw, *ops[0], **kws[0])
            if sp is not None:
                k, v = sequence.gather_kv(torch.stack([k, v]), sp,
                                          sequence.kv_visual_rows(sp, self.attn.sr_ratio))
        if self.v2:
            x = fused_block_attention(x, k, v, *ops[1], **kws[1])
            if sp is None:
                return fused_dwconv_mlp(x, hw, *ops[2], **kws[2])
            out = fused_dwconv_mlp(sequence.exchange_halo(x, sp), sp.halo_hw, *ops[2], **kws[2])
            return sequence.trim_halo(out, sp)
        return fused_block(x, k, v, *ops[1], **kws[1])

    def train_forward(self, x, hw, generator=None, *, attention=fused_attention,
                      ln_mlp=fused_ln_mlp, block_attention=fused_block_attention_train, sp=None):
        """The differentiable path on the fp32 master parameters. ``attention``,
        ``ln_mlp`` and ``block_attention`` are the kernels' wrappers; a check
        passes functions of the same signatures over their plain versions.
        The routes follow mvlt_tpu/models/pvlt.py:Block: in training mode with
        ``fused_attn_train`` a v1 block without dropout runs the attention
        half after the K/V projection as one ``block_attention`` call;
        otherwise Q, ``attention`` (or, with ``attn_drop`` in training mode,
        ``attention_dropout``), the projection and the DropPath add run apart.
        The MLP half is ``mlp_half`` (v1) or ``dwconv_mlp_half`` (v2).
        With ``attn_split`` the q and kv products take their inputs through
        ``copy_to_model`` and give the rank's heads, the attention
        probabilities' dropout keeps the rank's heads' slice of the whole
        mask, and the out-projection's partial is summed by
        ``reduce_from_model`` before its bias and the residual are added,
        once (``row_parallel_linear``); on the fused route the attention half
        is parallel/tensor.py:fused_attn_tp on the rank's heads (#6-#8 in
        their tensor-parallel modes: x whole into the kernels, the ranks'
        partials summed, then bp, the DropPath scale and the residual).
        Under sequence parallelism (``sp``)
        x holds the band's rows: ``kv_input`` gives the whole K/V input, and
        every other step runs on the band's rows. Both together: LN1's band
        is gathered whole (``model_input``), the K/V front end, q and the
        attention of the rank's heads run on the whole stream, and the
        out-projection's partials are reduce-scattered to the band."""
        a = self.attn
        b, _, d = x.shape
        hd = d // self.num_heads
        heads = a.q.weight.shape[0] // hd     # the rank's heads under tensor parallelism
        group = self.tp_group if self.attn_split else None
        normed = layer_norm_fp32(x, self.norm1.weight, self.norm1.bias, self.norm1.eps)
        sr = ((a.sr.weight, a.sr.bias, a.norm.weight, a.norm.bias)
              if a.sr_ratio > 1 else (None,) * 4)
        if group is not None and sp is not None:
            normed = model_input(normed, group, sp)
            kv_in = self.kv_input(normed, (sp.h, sp.w), *sr)
        else:
            kv_in = self.kv_input(normed, hw, *sr, sp=sp)
            if group is not None:
                normed, kv_in = copy_to_model(normed, group), copy_to_model(kv_in, group)
        n = normed.shape[1]
        k, v = split_kv(linear(kv_in, a.kv.weight, a.kv.bias), heads)
        if (self.fused_attn_train and self.training and not self.v2 and not self.drop
                and not self.attn_drop):
            args = (x, k, v, self.norm1.weight, self.norm1.bias, a.q.weight, a.q.bias,
                    a.proj.weight, a.proj.bias, self.drop_path_scale(x, generator))
            if group is None:
                x = block_attention(*args, heads=heads, eps=self.norm1.eps,
                                    save_stats=self.fused_attn_stats)
            else:
                x = fused_attn_tp(*args, heads=heads, eps=self.norm1.eps,
                                  save_stats=self.fused_attn_stats, group=group, sp=sp)
        else:
            q = linear(normed, a.q.weight, a.q.bias).reshape(b, n, heads, hd).transpose(1, 2)
            if self.attn_drop and self.training:
                o = attention_dropout(q, k, v, hd ** -0.5, self.attn_drop, generator,
                                      split_dim(group, 1),
                                      None if sp is None or group is not None else (2, sp))
            else:
                o = attention(q, k, v, hd ** -0.5)
            o = o.transpose(1, 2).reshape(b, n, heads * hd)
            attn_out = self.dropout(row_parallel_linear(o, a.proj.weight, a.proj.bias, group, sp),
                                    generator, sp=sp)
            x = _add_scaled(x, attn_out, self.drop_path_scale(x, generator))
        if self.v2:
            return self.dwconv_mlp_half(x, hw, generator, sp)
        return self.mlp_half(x, generator, ln_mlp, sp)

    def dwconv_mlp_half(self, x: torch.Tensor, hw: tuple,
                        generator: Optional[torch.Generator], sp=None) -> torch.Tensor:
        """x + s2 mlp(LN2 x) of PVT-v2's MLP, differentiable PyTorch glue:
        fc1, the 3x3 depthwise conv on the visual rows (the text rows passed
        through), exact GELU on every row, dropout, fc2, dropout. Counterpart
        of mvlt_tpu/models/pvlt.py:DWConvMlp (:250-276); kernel D serves
        only, as the JAX package's does. With ``mlp_split`` on the rank's
        hidden channels: fc1's rows, the conv's channels, the hidden's
        dropout mask sliced, fc2's partials summed before its bias. Under
        sequence parallelism (``sp``) LN2, fc1 and the conv run on the band
        with one halo grid row from each neighbour (sequence.exchange_halo)
        and the conv's halo rows are dropped; with ``mlp_split`` too LN2's
        band is gathered whole, fc1 and the conv run on the whole grid and
        fc2's partials are reduce-scattered to the band."""
        m = self.mlp
        b, _, _ = x.shape
        if sp is not None and self.mlp_split:
            h, w = sp.h, sp.w
            normed, group = self.mlp_hidden_in(x, sp)
            halo = None
        else:
            h, w = hw if sp is None else sp.halo_hw
            normed, group = self.mlp_hidden_in(x if sp is None else sequence.exchange_halo(x, sp))
            halo = sp
        hidden = linear(normed, m.fc1.weight, m.fc1.bias)
        c = hidden.shape[-1]
        dw = m.dwconv.dwconv
        vis = F.conv2d(hidden[:, : h * w].reshape(b, h, w, c).permute(0, 3, 1, 2),
                       dw.weight.to(x.dtype), dw.bias.to(x.dtype), padding=1, groups=c)
        hidden = torch.cat([vis.flatten(2).transpose(1, 2), hidden[:, h * w:]], dim=1)
        if halo is not None:
            hidden = sequence.trim_halo(hidden, sp)
        hidden = self.dropout(gelu(hidden), generator, split_dim(group, -1), halo)
        out = self.dropout(row_parallel_linear(hidden, m.fc2.weight, m.fc2.bias, group, sp),
                           generator, sp=sp)
        return _add_scaled(x, out, self.drop_path_scale(x, generator))


class SwinBlock(BlockGlue, nn.Module):
    """Pre-LN Swin block: x + s1 attn(LN1 x), then + s2 mlp(LN2 .), the
    window shifted by half on ``shift`` blocks; s1, s2 DropPath scales in
    training mode, ``drop`` the projection and MLP dropout. Serving (eval
    mode, no gradient wanted): on a stage ``swin_band_stage`` admits it
    takes and returns the split stream (visual rows [B, h*w, C], text rows
    [B, T, C]): kernel E runs the visual rows' whole block, PyTorch the text
    rows' (their queries over K/V of the pooled LN1 rows and of the text
    rows, then the MLP), as the JAX package's
    mvlt_tpu/models/pvlt.py:Block._swin_fused_block does. Elsewhere it takes
    the joint stream [B, h*w + T, C]: SwinJointAttention (kernel F), then the
    LN-MLP of ops/fused_mlp.py. Training mode, a gradient wanted, or a block
    split by tensor parallelism: the joint stream through
    ``train_forward``. Under sequence parallelism (a row plan ``sp``) the
    joint stream holds the rank's band, ``hw`` the band's grid, and the
    window path or ``train_forward`` runs on it (SwinJointAttention's
    ``sp``); kernel E never sees a band."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 window_size: int, shift: bool, table_ws: int, ln_eps: float = 1e-6,
                 drop_path: float = 0.0, drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.drop_path = drop_path
        self.drop = drop
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = SwinJointAttention(dim, num_heads, window_size, shift, qkv_bias, table_ws,
                                       drop)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def kernel_params(self) -> tuple[tuple, ...]:
        """The parameters in ``fused_swin_block``'s argument order after the
        bias table."""
        a, m = self.attn, self.mlp
        return ((self.norm1.weight, self.norm1.bias, a.q.weight, a.q.bias, a.kv.weight,
                 a.kv.bias, a.proj.weight, a.proj.bias, self.norm2.weight, self.norm2.bias,
                 m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias),)

    def kernel_kwargs(self, hw: tuple) -> dict:
        """``fused_swin_block``'s keyword arguments on a grid of ``hw``."""
        ws, shift = self.attn.window(hw)
        return dict(hw=hw, heads=self.num_heads, window=ws, shift=shift,
                    pool=max(1, hw[0] // TEXT_POOL), eps1=self.norm1.eps, eps2=self.norm2.eps)

    def forward(self, x, hw: tuple, generator: Optional[torch.Generator] = None, sp=None):
        joint = torch.is_tensor(x)
        if self.training or self.wants_grad(*((x,) if joint else x)) or self.tp_group is not None:
            if not joint:
                raise ValueError("the split stream (kernel E) serves only: PVLT passes "
                                 "the joint stream in training mode or with a gradient wanted")
            return self.train_forward(x, hw, generator, sp=sp)
        return self.window_forward(x, hw, sp=sp) if joint else self.band_forward(*x, hw)

    @staticmethod
    def text_rows(x: torch.Tensor, hw: tuple, sp) -> int:
        """The whole stream's text rows: T, which a band's table keeps."""
        return sp.t if sp is not None else x.shape[1] - hw[0] * hw[1]

    def train_forward(self, x: torch.Tensor, hw: tuple,
                      generator: Optional[torch.Generator] = None, *,
                      ln_mlp=fused_ln_mlp, sp=None) -> torch.Tensor:
        """The differentiable block on the joint stream: SwinJointAttention
        on its einsum route (``window_attention``), projection dropout and
        DropPath, then ``mlp_half`` (``ln_mlp``, the LN-MLP kernels' wrapper
        with DropPath as its row scale; a check passes its plain version).
        With ``attn_split`` the attention runs on the rank's heads and sums
        its out-projection's partials over the model group. ``sp``: x holds
        that row plan's band."""
        attn_out = self.attn(_ln(x, self.norm1), hw, self.text_rows(x, hw, sp),
                             generator=generator,
                             group=self.tp_group if self.attn_split else None, sp=sp)
        x = _add_scaled(x, attn_out, self.drop_path_scale(x, generator))
        return self.mlp_half(x, generator, ln_mlp, sp)

    def window_forward(self, x: torch.Tensor, hw: tuple, *, attention=fused_swin_attention,
                       ln_mlp=fused_ln_mlp, sp=None) -> torch.Tensor:
        """The joint stream's serving block: attention with kernel F, then the
        LN-MLP (``attention`` and ``ln_mlp`` the kernels' wrappers; a check
        passes their plain versions). ``sp``: x holds that row plan's band,
        kernel F runs on its windows."""
        x = x + self.attn(_ln(x, self.norm1), hw, self.text_rows(x, hw, sp),
                          attention=attention, sp=sp)
        m = self.mlp
        return ln_mlp(x, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                      m.fc2.weight, m.fc2.bias, None, self.norm2.eps)

    def text_qkv(self, xt: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The text rows' q, k and v [B, T, C] from their LN1, on the cast
        operands."""
        g1, be1, wq, bq, wkv, bkv = self.kernel_operands(xt.dtype)[0][:6]
        ln_t = layer_norm_fp32(xt, g1, be1, self.norm1.eps)
        kv_t = linear(ln_t, wkv, bkv)
        c = xt.shape[-1]
        return linear(ln_t, wq, bq), kv_t[..., :c].contiguous(), kv_t[..., c:].contiguous()

    def band_forward(self, xv: torch.Tensor, xt: torch.Tensor, hw: tuple, *,
                     block=fused_swin_block):
        """The split stream's block: kernel E (``block``, its wrapper; a check
        passes its plain version) on the visual rows, with the additive
        table cached beside the operands, the text rows in PyTorch on the
        pooled LN1 rows it returns."""
        ops = self.kernel_operands(xv.dtype)[0]
        _, _, _, _, wkv, bkv, wp, bp, g2, be2, w1, b1, w2, b2 = ops
        c, nh = xv.shape[-1], self.num_heads
        q_t, k_t, v_t = self.text_qkv(xt)
        t = xt.shape[1]
        table = self.kernel_table(xv.dtype, ("band", tuple(hw), t),
                                  lambda: self.attn.add_table(hw, t).contiguous())
        out_vis, pooled = block(xv, k_t, v_t, self.attn.relative_position_bias_table, *ops,
                                **self.kernel_kwargs(hw), table=table)
        # pool(LN1) then project equals project then pool: the projection is affine
        kv_p = linear(pooled, wkv, bkv)
        k_cat = torch.cat([heads_of(kv_p[..., :c], nh), heads_of(k_t, nh)], dim=-2)
        v_cat = torch.cat([heads_of(kv_p[..., c:], nh), heads_of(v_t, nh)], dim=-2)
        out_txt = softmax_av(heads_of(q_t, nh), k_cat, v_cat, scale=(c // nh) ** -0.5)
        xt = xt + linear(merge_heads(out_txt), wp, bp)
        hid = gelu(linear(layer_norm_fp32(xt, g2, be2, self.norm2.eps), w1, b1))
        return out_vis, xt + linear(hid, w2, b2)


def checkpoint_block(blk: nn.Module, z: torch.Tensor, hw: tuple,
                     generator: Optional[torch.Generator], **kwargs) -> torch.Tensor:
    """``blk(z, hw, generator)`` under torch.utils.checkpoint (``--remat``):
    its activations are recomputed in the backward instead of kept, as
    mvlt_tpu/models/pvlt.py:1194-1202 does with nn.remat. checkpoint replays
    only the default generators, so the block draws its DropPath scales and
    dropout masks from a generator started at ``generator``'s state: the
    recompute draws the same masks, and ``generator`` is then moved to where
    the block left it, as it would stand without remat. ``kwargs`` go to
    the block (a row plan ``sp``: the recompute repeats its collectives)."""
    if kwargs:
        blk = functools.partial(blk, **kwargs)
    if generator is None:
        return checkpoint(blk, z, hw, None, use_reentrant=False)
    start, end = generator.get_state(), []

    def run(z):
        gen = torch.Generator(device=generator.device)
        gen.set_state(start)
        out = blk(z, hw, gen)
        end.append(gen.get_state())
        return out

    out = checkpoint(run, z, use_reentrant=False)
    generator.set_state(end[0])
    return out


def resize_pos_embed(pos: torch.Tensor, native_hw: tuple, hw: tuple) -> torch.Tensor:
    """Bilinearly resize a [1, gh*gw, C] table to a new grid
    (align_corners=False, no antialias) as two fixed interpolation products
    (ops/upsample.py:resize_bilinear), whose backward is deterministic."""
    if tuple(native_hw) == tuple(hw):
        return pos
    (gh, gw), (h, w) = native_hw, hw
    c = pos.shape[-1]
    return resize_bilinear(pos.reshape(1, gh, gw, c), h, w).reshape(1, h * w, c)


class PVLT(nn.Module):
    """``model(images, input_ids)`` -> dict of logits as in the JAX package:
    ``mlm_logits``, ``itm_logits``, ``sup_cls_logits``, ``sub_cls_logits``
    and ``t2i_logits`` (NHWC), None for a head that is off. In training mode
    with ``cfg.mlm_loss_chunk > 0`` the MLM head returns ``mlm_hidden``,
    ``mlm_table``, ``mlm_bias`` and ``mlm_vocab_group`` instead of logits,
    and ``mlm_row_idx`` (from train/losses.py:mlm_gather_plan) picks the
    text rows it runs on.
    ``generator`` draws the dropout and DropPath masks.

    Parameters start at PyTorch's defaults (``create_model`` re-initialises
    them as the JAX package does); load trained or exported weights with
    ``load_state_dict``. A Swin model's relative-position tables are sized
    for the stage grids of ``input_size`` x ``input_size`` images, the size
    it then runs at (JAX sizes them from the images it initialises with).
    ``tp_group`` is the model group once parallel/tensor.py:shard_model has
    split it, ``vocab_group`` the same where the vocabulary is split.
    ``sp_group`` is the model group a sequence-parallel model
    (``create_model(..., sp_group=)``) splits each stage's rows over, where
    parallel/sequence.py:row_plan splits the stage; ``sp_split`` says
    which stages the last forward split (sequence.reduce_row_grads)."""

    tp_group = None
    vocab_group = None
    sp_group = None
    sp_split = ()

    def __init__(self, cfg: ModelConfig, input_size: int = DataConfig.input_size):
        super().__init__()
        if cfg.variant not in ("v1", "v2", "swin"):
            raise NotImplementedError(f"variant {cfg.variant!r} is not ported")
        v2 = cfg.variant == "v2"
        self.cfg = cfg
        self.input_size = input_size
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        eps = cfg.other_ln_eps
        lt = cfg.loss_type
        hidden = cfg.token_hidden_size
        self.text_embeddings = BertEmbeddings(
            cfg.vocab_size, hidden, cfg.max_position_embeddings,
            cfg.type_vocab_size, cfg.bert_ln_eps, cfg.bert_dropout)
        # stochastic-depth decay rule: linspace over the total depth
        dpr = iter(np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths)).tolist())
        grid = input_size // cfg.patch_size
        for i, dim in enumerate(cfg.embed_dims):
            prev = cfg.embed_dims[i - 1] if i else None
            native_g = cfg.img_size // (cfg.patch_size * 2 ** i)
            slots = native_g * native_g + (1 if i == cfg.num_stages - 1 else 0)
            stride = cfg.patch_size if i == 0 else 2
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(
                7 if i == 0 else 3, stride, prev or cfg.in_chans, dim, eps) if v2
                else PatchEmbed(stride, prev or cfg.in_chans, dim, eps))
            setattr(self, f"text_embed{i + 1}", nn.Sequential(
                nn.Linear(prev or hidden, dim), nn.LayerNorm(dim, eps=eps)))
            setattr(self, f"pos_embed{i + 1}", nn.Parameter(torch.zeros(1, slots, dim)))
            setattr(self, f"text_pos_embed{i + 1}",
                    nn.Parameter(torch.zeros(1, cfg.num_text_tokens, dim)))
            if cfg.variant == "swin":
                table_ws = window_size_for(cfg.window_size, (grid, grid))
                blocks = [SwinBlock(dim, cfg.num_heads[i], cfg.mlp_ratios[i], cfg.qkv_bias,
                                    cfg.window_size, j % 2 == 1, table_ws, cfg.block_ln_eps,
                                    next(dpr), cfg.drop_rate)
                          for j in range(cfg.depths[i])]
            else:
                # linear SR where the stage reduces (mvlt_tpu/models/pvlt.py:1212)
                linear_sr = cfg.linear_sr and cfg.sr_ratios[i] > 1
                blocks = [Block(dim, cfg.num_heads[i], cfg.mlp_ratios[i], cfg.sr_ratios[i],
                                cfg.qkv_bias, cfg.block_ln_eps, eps, next(dpr), v2,
                                cfg.fused_attn_train, cfg.fused_attn_stats, linear_sr,
                                cfg.drop_rate, cfg.attn_drop_rate)
                          for _ in range(cfg.depths[i])]
            setattr(self, f"block{i + 1}", nn.ModuleList(blocks))
            grid //= 2
        adapter = lambda: nn.Sequential(nn.Linear(cfg.embed_dims[-1], hidden),
                                        nn.LayerNorm(hidden, eps=eps))
        if lt.mlm:
            self.mlm_head_embed = adapter()
            self.mlm_head = MLMHead(cfg.vocab_size, hidden)
        if lt.itm:
            self.itm_head_embed = adapter()
            self.itm_head = ITMHead(hidden)
        if lt.cls:
            self.sup_cls_head_embed = adapter()
            self.sup_cls_head = CLSHead(cfg.num_super_classes, hidden)
            self.sub_cls_head_embed = adapter()
            self.sub_cls_head = CLSHead(cfg.num_sub_classes, hidden)
        if lt.t2i:
            self.t2i_head = ITGHead(cfg.embed_dims, cfg.itg_channel)

    def _adapter(self, name: str, feat: torch.Tensor) -> torch.Tensor:
        dense, norm = getattr(self, f"{name}_head_embed")
        return _ln(linear(feat, dense.weight, dense.bias), norm)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor, *,
                mlm_row_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Optional[torch.Tensor]]:
        cfg = self.cfg
        dtype = self.compute_dtype
        # eval mode with no gradient wanted: the serving kernels (the JAX
        # package's `deterministic`, and no VJP through a serving kernel)
        # (a model split by tensor parallelism takes the training route; a
        # sequence-parallel one serves on its bands)
        serving = self.tp_group is None and not self.training and not (
            torch.is_grad_enabled() and (
                images.requires_grad or any(p.requires_grad for p in self.parameters())))
        if images.shape[-1] != cfg.in_chans and images.shape[1] == cfg.in_chans:
            images = images.permute(0, 2, 3, 1)        # NCHW accepted
        b = images.shape[0]
        y = self.text_embeddings(input_ids, generator, self.vocab_group).to(dtype)
        x = images.to(dtype)
        img_feats, split = [], []
        for i, dim in enumerate(cfg.embed_dims):
            x, (h, w) = getattr(self, f"patch_embed{i + 1}")(x)
            dense, norm = getattr(self, f"text_embed{i + 1}")
            y = _ln(linear(y, dense.weight, dense.bias), norm)
            pos = getattr(self, f"pos_embed{i + 1}")
            if i == cfg.num_stages - 1:
                pos = pos[:, 1:]                       # PVT cls slot
            native_g = cfg.img_size // (cfg.patch_size * 2 ** i)
            pos = resize_pos_embed(pos.to(dtype), (native_g, native_g), (h, w))
            text_pos = getattr(self, f"text_pos_embed{i + 1}").to(dtype)
            plan = sequence.stage_plan(self, i, h, w, y.shape[1])
            if (serving and cfg.variant == "swin" and plan is None
                    and swin_band_stage(cfg.window_size, (h, w))):
                z = (x + pos, y + text_pos)              # split: kernel E's stage
            else:
                z = torch.cat([x + pos, y + text_pos], dim=1)
                if self.training and cfg.drop_rate:
                    z = dropout(z, cfg.drop_rate, generator)
            # sequence parallelism: the rank's band and text rows, whole again after
            kw = {} if plan is None else {"sp": plan}
            if plan is not None:
                z = sequence.split_rows(z, plan)
            for blk in getattr(self, f"block{i + 1}"):
                if cfg.remat and not serving:
                    z = checkpoint_block(blk, z, plan.hw if plan else (h, w), generator, **kw)
                else:
                    z = blk(z, plan.hw if plan else (h, w), generator, **kw)
            if plan is not None:
                z = sequence.gather_rows(z, plan)
            split.append(plan is not None)
            x, y = z if isinstance(z, tuple) else (z[:, : h * w], z[:, h * w:])
            x = x.reshape(b, h, w, dim)
            img_feats.append(x)
        self.sp_split = tuple(split)

        lt = cfg.loss_type
        out: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
            ("mlm_logits", "itm_logits", "sup_cls_logits", "sub_cls_logits", "t2i_logits"))
        if lt.mlm:
            table = self.text_embeddings.word_embeddings.weight
            if self.training and cfg.mlm_loss_chunk > 0:
                rows = y if mlm_row_idx is None else y.reshape(-1, y.shape[-1])[mlm_row_idx][None]
                hid, bias = self.mlm_head(self._adapter("mlm", rows), table, decode=False)
                out.update(mlm_hidden=hid, mlm_table=table, mlm_bias=bias,
                           mlm_vocab_group=self.vocab_group)
            else:
                out["mlm_logits"] = self.mlm_head(self._adapter("mlm", y), table,
                                                  vocab_group=self.vocab_group)
        cls_feat = y[:, 0:1]
        if lt.itm:
            out["itm_logits"] = self.itm_head(self._adapter("itm", cls_feat))
        if lt.cls:
            out["sup_cls_logits"] = self.sup_cls_head(self._adapter("sup_cls", cls_feat))
            out["sub_cls_logits"] = self.sub_cls_head(self._adapter("sub_cls", cls_feat))
        if lt.t2i:
            out["t2i_logits"] = self.t2i_head(*img_feats[1:4]).float()
        return out


def _trunc_normal(t: torch.Tensor, std: float) -> None:
    """A normal of scale ``std`` truncated at two scales (jax.nn.initializers'
    truncated normal)."""
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std)


def init_weights(model: PVLT) -> PVLT:
    """The JAX package's initialisers (its flax modules' ``kernel_init``),
    in place, from torch's global generator: Linear and conv weights and
    the positional embeddings truncated normal 0.02; in the T2I decoder the
    ConvBN convolutions He normal over fan-out; the T2I score conv and v2's
    depthwise convs (flax's default, no ``kernel_init`` given) LeCun normal;
    Swin's relative-position tables truncated normal 0.02; embedding tables
    normal 0.02; every bias 0. LayerNorm and BatchNorm keep
    torch's (scale 1, shift 0, running variance 1)."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=0.02)
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                if name == "t2i_head.score.0" or name.endswith(".dwconv.dwconv"):
                    # lecun_normal: variance 1/fan_in, truncated, std-corrected
                    fan_in = m.weight[0].numel()
                    _trunc_normal(m.weight, fan_in ** -0.5 / 0.87962566103423978)
                elif name.startswith("t2i_head."):
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
                else:
                    _trunc_normal(m.weight, 0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for name, p in model.named_parameters():
            if "pos_embed" in name or name.endswith("relative_position_bias_table"):
                _trunc_normal(p, 0.02)
    return model


def create_model(cfg: ModelConfig, *, device="cuda",
                 input_size: int = DataConfig.input_size, sp_group=None) -> PVLT:
    """A PVLT for ``cfg`` with the registry preset for ``cfg.name`` applied,
    initialised as the JAX package initialises it (``init_weights``), on
    ``device`` (the card unless the caller asks for another); a Swin model
    for images of ``input_size``. ``sp_group``: a sequence-parallel model
    whose stages split their rows over that model group
    (parallel/mesh.py:model_group after init_model_parallel), as the JAX
    package's ``create_model(cfg, sp_mesh=mesh)``; every rank of the group
    holds the whole model and must start from the same weights;
    parallel/tensor.py:shard_model over the same group then splits its
    weights as well."""
    cfg = resolve_model_config(cfg)
    validate_model_config(cfg)
    model = init_weights(PVLT(cfg, input_size)).to(device)
    model.sp_group = sp_group
    return model
