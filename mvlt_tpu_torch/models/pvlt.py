"""PVLT, the Pyramid Vision-Language Transformer, in PyTorch (v1 backbone).

Counterpart of mvlt_tpu/models/pvlt.py: a 4-stage PVT pyramid whose stages
each re-project the BERT text tokens and concatenate them with the image
patch tokens, attend jointly with spatial-reduction attention on the visual
K/V only, and split the stream back. Parameters carry the reference's torch
state-dict names (mvlt_tpu/convert/torch_to_jax.py:_MAPPING), so a state dict
exported from the JAX package or a published ``.pth`` loads with
``strict=True``. Reference quirks kept: built at ``img_size`` 224 and run at
256 through a bilinear pos-embed resize; the stage-4 pos-embed has one extra
slot, dropped at use; NHWC images in (NCHW accepted).

Parameters stay fp32; with ``compute_dtype="bfloat16"`` the stream and the
matrix-product operands are bf16 and LayerNorm statistics and softmax fp32.
A block has two paths, each the plain PyTorch versions on a CPU tensor and
Hopper kernels and nothing else in their place on a CUDA tensor:
  * serving, in eval mode when no gradient is wanted: ops/sr_kv.py then
    ops/block_fused.py, on bf16 operands cast once and detached;
  * training, whenever a gradient is wanted or in training mode: the
    projections, SR conv and SR-LN in PyTorch, the attention core of
    ops/pallas_attention.py and the LN-MLP of ops/fused_mlp.py, both
    differentiable, with DropPath (training mode only) as per-sample scales.
The training forward returns the MLM head's transformed hidden rows, the
tied table and the bias (``mlm_hidden``, ``mlm_table``, ``mlm_bias``) in
place of the [B, T, vocab] logits, for the chunked loss; eval returns all
five logits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.config import ModelConfig
from mvlt_tpu_torch.models.bert_embeddings import BertEmbeddings
from mvlt_tpu_torch.models.heads import CLSHead, ITGHead, ITMHead, MLMHead
from mvlt_tpu_torch.models.registry import resolve_model_config, validate_model_config
from mvlt_tpu_torch.ops.block_fused import fused_block
from mvlt_tpu_torch.ops.fused_mlp import fused_ln_mlp
from mvlt_tpu_torch.ops.kernel_math import layer_norm_fp32, linear
from mvlt_tpu_torch.ops.pallas_attention import fused_attention
from mvlt_tpu_torch.ops.sr_kv import fused_ln_sr_kv, reduce_kv_input, split_kv


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return layer_norm_fp32(x, norm.weight, norm.bias, norm.eps)


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
        y = F.conv2d(x.permute(0, 3, 1, 2), self.proj.weight.to(x.dtype),
                     self.proj.bias.to(x.dtype), stride=p)
        gh, gw = y.shape[-2:]
        return _ln(y.flatten(2).transpose(1, 2), self.norm), (gh, gw)


class JointSRAttention(nn.Module):
    """Parameters of the joint image+text attention with spatial reduction on
    the visual K/V: queries from all N rows, K/V from
    [SR-LN(SRconv(visual)) ; text]. ``Block`` computes it on one of its
    two paths."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=ln_eps)


class Mlp(nn.Module):
    """Parameters of Linear -> exact-erf GELU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def kernel_operand(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A parameter as the wrappers take it: matrices in the compute dtype (the
    SR conv weight channels-last, the [out, (r, s, in)] layout kernel A
    reads), vectors fp32 as they are."""
    if t is None or t.dim() == 1:
        return t
    t = t.detach()
    if t.dim() == 4:
        return t.to(dtype, memory_format=torch.channels_last)
    return t.to(dtype)


class Block(nn.Module):
    """Pre-LN block: x + s1 attn(LN1 x), then + s2 mlp(LN2 .), where s1, s2
    are per-sample DropPath scales (mask / keep) in training mode and 1 in
    eval. Serving path or training path as the module docstring says."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, sr_ratio: int,
                 qkv_bias: bool, ln_eps: float = 1e-6, sr_ln_eps: float = 1e-5,
                 drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = JointSRAttention(dim, num_heads, sr_ratio, qkv_bias, sr_ln_eps)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._operands = None

    def kernel_params(self) -> tuple[tuple, tuple]:
        """The parameters in the argument order of ``fused_ln_sr_kv`` and of
        ``fused_block``; the SR ones are None at sr == 1."""
        a, m = self.attn, self.mlp
        sr = ((a.sr.weight, a.sr.bias, a.norm.weight, a.norm.bias)
              if a.sr_ratio > 1 else (None,) * 4)
        return ((self.norm1.weight, self.norm1.bias, *sr, a.kv.weight, a.kv.bias),
                (self.norm1.weight, self.norm1.bias, a.q.weight, a.q.bias,
                 a.proj.weight, a.proj.bias, self.norm2.weight, self.norm2.bias,
                 m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias))

    def kernel_kwargs(self) -> tuple[dict, dict]:
        """The keyword arguments of ``fused_ln_sr_kv`` and of ``fused_block``."""
        a = self.attn
        return (dict(sr=a.sr_ratio, heads=self.num_heads, eps1=self.norm1.eps,
                     eps_sr=a.norm.eps if a.sr_ratio > 1 else 1e-5),
                dict(heads=self.num_heads, eps1=self.norm1.eps, eps2=self.norm2.eps))

    def kernel_operands(self, dtype: torch.dtype) -> tuple[tuple, tuple]:
        """``kernel_params`` cast by ``kernel_operand`` once, and again only
        after a parameter changed in place (load_state_dict), moved, or the
        compute dtype changed."""
        stamp = (dtype, *((p.device, p.data_ptr(), p._version) for p in self.parameters()))
        if self._operands is None or self._operands[0] != stamp:
            self._operands = (stamp, tuple(tuple(kernel_operand(t, dtype) for t in group)
                                           for group in self.kernel_params()))
        return self._operands[1]

    def _apply(self, fn, *args, **kwargs):
        self._operands = None
        return super()._apply(fn, *args, **kwargs)

    def drop_path_scale(self, x: torch.Tensor,
                        generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """Per-sample stochastic-depth scale [B] fp32 (Bernoulli(keep) /
        keep) in training mode, None where DropPath is off."""
        if not self.training or self.drop_path == 0.0:
            return None
        keep = 1.0 - self.drop_path
        mask = torch.rand(x.shape[0], generator=generator, device=x.device) < keep
        return mask.float() / keep

    def forward(self, x: torch.Tensor, hw: tuple,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        wants_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if self.training or wants_grad:
            return self.train_forward(x, hw, generator)
        kv_ops, block_ops = self.kernel_operands(x.dtype)
        kv_kw, block_kw = self.kernel_kwargs()
        k, v = fused_ln_sr_kv(x, hw, *kv_ops, **kv_kw)
        return fused_block(x, k, v, *block_ops, **block_kw)

    def train_forward(self, x, hw, generator=None, *, attention=fused_attention,
                      ln_mlp=fused_ln_mlp):
        """The differentiable path on the fp32 master parameters. ``attention``
        and ``ln_mlp`` are the kernels' wrappers; a check passes functions of
        the same signatures over their plain versions."""
        a, m = self.attn, self.mlp
        b, n, d = x.shape
        heads = self.num_heads
        hd = d // heads
        normed = layer_norm_fp32(x, self.norm1.weight, self.norm1.bias, self.norm1.eps)
        q = linear(normed, a.q.weight, a.q.bias).reshape(b, n, heads, hd).transpose(1, 2)
        sr = ((a.sr.weight, a.sr.bias, a.norm.weight, a.norm.bias, a.norm.eps)
              if a.sr_ratio > 1 else (None,) * 4 + (1e-5,))
        kv_in = reduce_kv_input(normed, hw, a.sr_ratio, *sr)
        k, v = split_kv(linear(kv_in, a.kv.weight, a.kv.bias), heads)
        o = attention(q, k, v, hd ** -0.5).transpose(1, 2).reshape(b, n, d)
        attn_out = linear(o, a.proj.weight, a.proj.bias)
        s1 = self.drop_path_scale(x, generator)
        x = x + (attn_out if s1 is None else attn_out * s1.to(x.dtype)[:, None, None])
        return ln_mlp(x, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                      m.fc2.weight, m.fc2.bias, self.drop_path_scale(x, generator),
                      self.norm2.eps)


def resize_pos_embed(pos: torch.Tensor, native_hw: tuple, hw: tuple) -> torch.Tensor:
    """Bilinearly resize a [1, gh*gw, C] table to a new grid
    (align_corners=False, no antialias)."""
    if tuple(native_hw) == tuple(hw):
        return pos
    (gh, gw), (h, w) = native_hw, hw
    c = pos.shape[-1]
    grid = pos.reshape(1, gh, gw, c).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)
    return grid.permute(0, 2, 3, 1).reshape(1, h * w, c)


class PVLT(nn.Module):
    """``model(images, input_ids)`` -> dict of logits as in the JAX package:
    ``mlm_logits``, ``itm_logits``, ``sup_cls_logits``, ``sub_cls_logits``
    and ``t2i_logits`` (NHWC), None for a head that is off. In training mode
    with ``cfg.mlm_loss_chunk > 0`` the MLM head returns ``mlm_hidden``,
    ``mlm_table`` and ``mlm_bias`` instead of logits, and ``mlm_row_idx``
    (from train/losses.py:mlm_gather_plan) picks the text rows it runs on.
    ``generator`` draws the dropout and DropPath masks.

    Parameters start at PyTorch's defaults (``create_model`` re-initialises
    them as the JAX package does); load trained or exported weights with
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.variant != "v1" or cfg.linear_sr:
            raise NotImplementedError(f"variant {cfg.variant!r} is not ported yet")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        eps = cfg.other_ln_eps
        lt = cfg.loss_type
        hidden = cfg.token_hidden_size
        self.text_embeddings = BertEmbeddings(
            cfg.vocab_size, hidden, cfg.max_position_embeddings,
            cfg.type_vocab_size, cfg.bert_ln_eps, cfg.bert_dropout)
        # stochastic-depth decay rule: linspace over the total depth
        dpr = iter(np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths)).tolist())
        for i, dim in enumerate(cfg.embed_dims):
            prev = cfg.embed_dims[i - 1] if i else None
            native_g = cfg.img_size // (cfg.patch_size * 2 ** i)
            slots = native_g * native_g + (1 if i == cfg.num_stages - 1 else 0)
            setattr(self, f"patch_embed{i + 1}", PatchEmbed(
                cfg.patch_size if i == 0 else 2, prev or cfg.in_chans, dim, eps))
            setattr(self, f"text_embed{i + 1}", nn.Sequential(
                nn.Linear(prev or hidden, dim), nn.LayerNorm(dim, eps=eps)))
            setattr(self, f"pos_embed{i + 1}", nn.Parameter(torch.zeros(1, slots, dim)))
            setattr(self, f"text_pos_embed{i + 1}",
                    nn.Parameter(torch.zeros(1, cfg.num_text_tokens, dim)))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, cfg.num_heads[i], cfg.mlp_ratios[i], cfg.sr_ratios[i],
                      cfg.qkv_bias, cfg.block_ln_eps, eps, next(dpr))
                for _ in range(cfg.depths[i])))
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
        if self.training and (cfg.drop_rate or cfg.attn_drop_rate):
            raise NotImplementedError("drop_rate and attn_drop_rate are not ported: "
                                      "training needs both at 0")
        dtype = self.compute_dtype
        if images.shape[-1] != cfg.in_chans and images.shape[1] == cfg.in_chans:
            images = images.permute(0, 2, 3, 1)        # NCHW accepted
        b = images.shape[0]
        y = self.text_embeddings(input_ids, generator).to(dtype)
        x = images.to(dtype)
        img_feats = []
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
            z = torch.cat([x + pos, y + text_pos], dim=1)
            for blk in getattr(self, f"block{i + 1}"):
                z = blk(z, (h, w), generator)
            x = z[:, : h * w].reshape(b, h, w, dim)
            y = z[:, h * w:]
            img_feats.append(x)

        lt = cfg.loss_type
        out: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
            ("mlm_logits", "itm_logits", "sup_cls_logits", "sub_cls_logits", "t2i_logits"))
        if lt.mlm:
            table = self.text_embeddings.word_embeddings.weight
            if self.training and cfg.mlm_loss_chunk > 0:
                rows = y if mlm_row_idx is None else y.reshape(-1, y.shape[-1])[mlm_row_idx][None]
                hid, bias = self.mlm_head(self._adapter("mlm", rows), table, decode=False)
                out.update(mlm_hidden=hid, mlm_table=table, mlm_bias=bias)
            else:
                out["mlm_logits"] = self.mlm_head(self._adapter("mlm", y), table)
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
    ConvBN convolutions He normal over fan-out and the score conv LeCun
    normal; embedding tables normal 0.02; every bias 0. LayerNorm and
    BatchNorm keep torch's (scale 1, shift 0, running variance 1)."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=0.02)
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                if name == "t2i_head.score.0":
                    # lecun_normal: variance 1/fan_in, truncated, std-corrected
                    fan_in = m.weight[0].numel()
                    _trunc_normal(m.weight, fan_in ** -0.5 / 0.87962566103423978)
                elif name.startswith("t2i_head."):
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
                else:
                    _trunc_normal(m.weight, 0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for name, p in model.named_parameters(recurse=False):
            if "pos_embed" in name:
                _trunc_normal(p, 0.02)
    return model


def create_model(cfg: ModelConfig, *, device="cuda") -> PVLT:
    """A PVLT for ``cfg`` with the registry preset for ``cfg.name`` applied,
    initialised as the JAX package initialises it (``init_weights``), on
    ``device`` (the card unless the caller asks for another)."""
    cfg = resolve_model_config(cfg)
    validate_model_config(cfg)
    return init_weights(PVLT(cfg)).to(device)
