"""Plain PyTorch reference of PVLT (PVT-v1 and PVT-v2 backbones) with its
ITM, MLM and T2I heads and pre-training losses, and the AdamW update.

It follows the published descriptions (PVT, arXiv:2102.12122; PVTv2,
arXiv:2106.13797; BERT's embeddings and MLM head; MVLT's joint stream of
image patches and text tokens with spatial reduction on the visual keys and
values) and works on a dict of weights named as the reference repository's
torch state dict. Everything is float32 unless ``Precision`` says
otherwise; no kernel, cache or batching of the program is used, and nothing
of the program is imported.

The joint stream of one stage is [visual rows of the h x w grid ; text rows].
Attention takes its queries from every row and its keys and values from
[SR-LN(SR-conv(visual rows)) ; text rows] (the visual rows alone are reduced,
by a k = stride = sr conv; at sr 1 the stream itself). The MLP is
fc1 -> exact GELU -> fc2 (v1) or fc1 -> 3x3 depthwise conv over the visual
grid, the text rows passed through -> GELU -> fc2 (v2). Positional tables
are built for 224 x 224 and resized bilinearly (half-pixel centres) to the
grid of the input; stage 4's table carries one extra slot, dropped.

Randomness in training (BERT dropout 0.1, DropPath over the depth) is drawn
from a ``torch.Generator`` in this order: the embeddings' dropout mask
(uniforms of the [B, T, 768] output, kept below 1 - rate), then for each
block with a DropPath rate above 0 one uniform per sample for the attention
branch and one for the MLP branch (kept below 1 - rate, scaled by
1 / (1 - rate)). Given the generator's seed, the masks are worked out again
here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact_float32() -> None:
    """Float32 products in full float32 on the card: TF32 off for matmuls
    and for cuDNN's convolutions (which default to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


E5M2_MAX = 57344.0  # largest finite float8_e5m2


def _round_to(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to the float8 ``dtype`` under one scale for the tensor (its
    absolute maximum onto ``top``), returned in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 (per-tensor scale), the gradient passing
    straight through."""
    return t + (_round_to(t.detach(), torch.float8_e4m3fn, FP8_MAX) - t).detach()


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to float8
    e5m2 (per-tensor scale): the gradient operand of an fp8 product's
    backward, as fp8 training feeds it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2, E5M2_MAX)


@dataclass(frozen=True)
class Precision:
    """The precision of every product (linear, conv, attention): ``fp32``,
    or ``fp8``: each operand rounded to float8 e4m3 and, in a backward, the
    product's incoming gradient to float8 e5m2, both with a per-tensor
    scale, sums in float32 (fp8 training's formats): the control of a
    bfloat16 configuration."""

    kind: str = "fp32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.kind == "fp8" else t

    def out(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind != "fp8" or not t.requires_grad:
            return t
        return _GradE5M2.apply(t)

    def linear(self, x, w, b=None):
        return self.out(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, w, b=None, **kw):
        return self.out(F.conv2d(self.q(x), self.q(w), b, **kw))

    def matmul(self, a, b):
        return self.out(torch.matmul(self.q(a), self.q(b)))


@dataclass(frozen=True)
class Arch:
    """The sizes the reference needs, read from a configuration file."""

    variant: str = "v1"
    embed_dims: tuple = (64, 128, 320, 512)
    num_heads: tuple = (1, 2, 5, 8)
    mlp_ratios: tuple = (8, 8, 4, 4)
    depths: tuple = (2, 2, 2, 2)
    sr_ratios: tuple = (8, 4, 2, 1)
    patch_size: int = 4
    img_size: int = 224
    num_text_tokens: int = 128
    token_hidden_size: int = 768
    vocab_size: int = 30522
    drop_path_rate: float = 0.1
    bert_dropout: float = 0.1
    block_ln_eps: float = 1e-6
    other_ln_eps: float = 1e-5
    bert_ln_eps: float = 1e-12
    head_ln_eps: float = 1e-5
    bn_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "Arch":
        keys = cls.__dataclass_fields__
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in keys})

    def drop_path_rates(self) -> list:
        return np.linspace(0.0, self.drop_path_rate, sum(self.depths)).tolist()


def ln(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def gelu(x):
    return F.gelu(x, approximate="none")


class Draws:
    """The training masks, drawn from ``generator`` in the documented order;
    no generator (or eval) draws nothing."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.g = generator

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.g is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.g, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def drop_path(self, batch: int, rate: float, device) -> Optional[torch.Tensor]:
        if self.g is None or rate == 0.0:
            return None
        keep = 1.0 - rate
        mask = torch.rand(batch, generator=self.g, device=device) < keep
        return mask.float() / keep


def _scaled(out: torch.Tensor, s: Optional[torch.Tensor]) -> torch.Tensor:
    return out if s is None else out * s[:, None, None]


def attention(p: Precision, q, k, v):
    """softmax(q k^T / sqrt(hd)) v over [B, H, rows, hd]."""
    logits = p.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return p.matmul(torch.softmax(logits, dim=-1), v)


def block(p: Precision, arch: Arch, sd, name: str, z, hw, heads: int, sr: int,
          s1=None, s2=None):
    """One pre-LN block on the joint stream z [B, h*w + T, D]."""
    b, n, d = z.shape
    h, w = hw
    hd = d // heads
    n1 = ln(z, sd, f"{name}.norm1", arch.block_ln_eps)
    if sr > 1:
        grid = n1[:, : h * w].transpose(1, 2).reshape(b, d, h, w)
        red = p.conv(grid, sd[f"{name}.attn.sr.weight"], sd[f"{name}.attn.sr.bias"], stride=sr)
        red = ln(red.flatten(2).transpose(1, 2), sd, f"{name}.attn.norm", arch.other_ln_eps)
        kv_in = torch.cat([red, n1[:, h * w:]], dim=1)
    else:
        kv_in = n1
    kv = p.linear(kv_in, sd[f"{name}.attn.kv.weight"], sd[f"{name}.attn.kv.bias"])
    kv = kv.reshape(b, -1, 2, heads, hd).permute(2, 0, 3, 1, 4)
    q = p.linear(n1, sd[f"{name}.attn.q.weight"], sd[f"{name}.attn.q.bias"])
    q = q.reshape(b, n, heads, hd).transpose(1, 2)
    o = attention(p, q, kv[0], kv[1]).transpose(1, 2).reshape(b, n, d)
    z = z + _scaled(p.linear(o, sd[f"{name}.attn.proj.weight"], sd[f"{name}.attn.proj.bias"]), s1)
    n2 = ln(z, sd, f"{name}.norm2", arch.block_ln_eps)
    hid = p.linear(n2, sd[f"{name}.mlp.fc1.weight"], sd[f"{name}.mlp.fc1.bias"])
    if arch.variant == "v2":
        c = hid.shape[-1]
        vis = hid[:, : h * w].transpose(1, 2).reshape(b, c, h, w)
        vis = p.conv(vis, sd[f"{name}.mlp.dwconv.dwconv.weight"],
                     sd[f"{name}.mlp.dwconv.dwconv.bias"], padding=1, groups=c)
        hid = torch.cat([vis.flatten(2).transpose(1, 2), hid[:, h * w:]], dim=1)
    out = p.linear(gelu(hid), sd[f"{name}.mlp.fc2.weight"], sd[f"{name}.mlp.fc2.bias"])
    return z + _scaled(out, s2)


def resize_pos(pos: torch.Tensor, native: int, h: int, w: int) -> torch.Tensor:
    """[1, native^2, C] -> [1, h*w, C], bilinear with half-pixel centres."""
    if (native, native) == (h, w):
        return pos
    c = pos.shape[-1]
    grid = pos.reshape(1, native, native, c).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(1, h * w, c)


def backbone(p: Precision, arch: Arch, sd, images, input_ids, draws: Draws):
    """images NHWC [B, H, W, 3] float, input_ids [B, T] -> (stage maps NHWC,
    text rows [B, T, 768] of stage 4's width... the last stage's text rows)."""
    b, t = input_ids.shape
    emb = (sd["text_embeddings.word_embeddings.weight"][input_ids]
           + sd["text_embeddings.position_embeddings.weight"][:t]
           + sd["text_embeddings.token_type_embeddings.weight"][0])
    y = draws.dropout(ln(emb, sd, "text_embeddings.LayerNorm", arch.bert_ln_eps),
                      arch.bert_dropout)
    x = images.permute(0, 3, 1, 2)
    dpr = iter(arch.drop_path_rates())
    feats = []
    for i, dim in enumerate(arch.embed_dims):
        s = i + 1
        if arch.variant == "v2":
            k, stride = (7, arch.patch_size) if i == 0 else (3, 2)
            pad = k // 2
        else:
            k = stride = arch.patch_size if i == 0 else 2
            pad = 0
        x = p.conv(x, sd[f"patch_embed{s}.proj.weight"], sd[f"patch_embed{s}.proj.bias"],
                   stride=stride, padding=pad)
        h, w = x.shape[-2:]
        x = ln(x.flatten(2).transpose(1, 2), sd, f"patch_embed{s}.norm", arch.other_ln_eps)
        y = ln(p.linear(y, sd[f"text_embed{s}.0.weight"], sd[f"text_embed{s}.0.bias"]),
               sd, f"text_embed{s}.1", arch.other_ln_eps)
        pos = sd[f"pos_embed{s}"]
        if i == len(arch.embed_dims) - 1:
            pos = pos[:, 1:]
        native = arch.img_size // (arch.patch_size * 2 ** i)
        z = torch.cat([x + resize_pos(pos, native, h, w), y + sd[f"text_pos_embed{s}"]], dim=1)
        for j in range(arch.depths[i]):
            rate = next(dpr)
            s1 = draws.drop_path(b, rate, z.device)
            # the MLP branch's scale is drawn after the attention branch ran;
            # the order of draws is what matters, not when they are used
            s2 = draws.drop_path(b, rate, z.device)
            args = (p, arch, sd, f"block{s}.{j}", z, (h, w), arch.num_heads[i],
                    arch.sr_ratios[i], s1, s2)
            # with a gradient wanted each block's activations are recomputed
            # in the backward (no draws inside a block), so that the float32
            # reference of a large batch fits beside nothing else
            z = (checkpoint(block, *args, use_reentrant=False) if torch.is_grad_enabled()
                 else block(*args))
        x = z[:, : h * w]
        y = z[:, h * w:]
        feats.append(x.reshape(b, h, w, dim))
        x = x.transpose(1, 2).reshape(b, dim, h, w)
    return feats, y


def adapter(p: Precision, arch: Arch, sd, name: str, feat):
    return ln(p.linear(feat, sd[f"{name}_head_embed.0.weight"], sd[f"{name}_head_embed.0.bias"]),
              sd, f"{name}_head_embed.1", arch.other_ln_eps)


def itm_logits(p: Precision, arch: Arch, sd, y, features: bool = False):
    """[B, 2] from the first text row of the last stage; with ``features``
    also the head's input [B, 768] (the adapter's output)."""
    f = adapter(p, arch, sd, "itm", y[:, 0])
    logits = (p.linear(f, sd["itm_head.linear.weight"], sd["itm_head.linear.bias"])
              + sd["itm_head.linear_bias"])
    return (logits, f) if features else logits


def mlm_hidden(p: Precision, arch: Arch, sd, rows):
    """The MLM head's transformed rows [R, 768] (adapter, dense, GELU, LN)."""
    f = adapter(p, arch, sd, "mlm", rows)
    f = gelu(p.linear(f, sd["mlm_head.transform.dense.weight"], sd["mlm_head.transform.dense.bias"]))
    return ln(f, sd, "mlm_head.transform.LayerNorm", arch.head_ln_eps)


def _sum_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of ``group`` with a gradient through the sum
    (t itself without a group)."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def conv_bn(p: Precision, arch: Arch, sd, name: str, x, training: bool, group=None):
    """3x3 conv (no bias) then BatchNorm over NCHW; in training the batch's
    mean and biased variance (the whole batch of every rank of ``group``),
    else the running ones."""
    y = p.conv(x, sd[f"{name}.0.weight"], None, padding=1)
    if training:
        count = _sum_ranks(y.new_full((1,), y.numel() // y.shape[1]), group)
        mean = _sum_ranks(y.sum((0, 2, 3)), group) / count
        var = _sum_ranks((y - mean[:, None, None]).square().sum((0, 2, 3)), group) / count
    else:
        mean, var = sd[f"{name}.1.running_mean"], sd[f"{name}.1.running_var"]
    scale = sd[f"{name}.1.weight"] * torch.rsqrt(var + arch.bn_eps)
    return (y - mean[:, None, None]) * scale[:, None, None] + sd[f"{name}.1.bias"][:, None, None]


def t2i_logits(p: Precision, arch: Arch, sd, feats, training: bool, group=None):
    """The T2I pixel decoder over stage 2-4 maps -> [B, H, W, 3]."""
    nchw = [f.permute(0, 3, 1, 2) for f in feats[1:4]]
    up = lambda t, s=2: F.interpolate(t, scale_factor=s, mode="bilinear", align_corners=True)
    cb = lambda name, t: conv_bn(p, arch, sd, f"t2i_head.{name}", t, training, group)
    low, mid, high = cb("reduction1", nchw[0]), cb("reduction2", nchw[1]), cb("reduction3", nchw[2])
    x2_1 = cb("conv_upsample1", up(high)) * mid
    x3_1 = cb("conv_upsample2", up(mid)) * cb("conv_upsample3", up(x2_1)) * low
    x2_2 = cb("conv_concat2", torch.cat([x2_1, cb("conv_upsample4", up(high))], dim=1))
    x3_2 = cb("conv_concat3", torch.cat([x3_1, cb("conv_upsample5", up(x2_2))], dim=1))
    refined = cb("conv4", x3_2)
    score = p.conv(refined, sd["t2i_head.score.0.weight"], sd["t2i_head.score.0.bias"])
    return up(score, 8).permute(0, 2, 3, 1)


def serve_itm(arch: Arch, sd, images, input_ids, precision: Precision = Precision(),
              features: bool = False):
    """ITM logits [B, 2] of the eval forward (no dropout, no DropPath); with
    ``features`` also the ITM head's input [B, 768]."""
    _, y = backbone(precision, arch, sd, images, input_ids, Draws(None))
    return itm_logits(precision, arch, sd, y, features)


def pretrain_losses(arch: Arch, sd, batch: Dict[str, torch.Tensor], masked_input: bool,
                    generator: Optional[torch.Generator],
                    precision: Precision = Precision(), group=None) -> Dict[str, torch.Tensor]:
    """The pre-training objective on one batch in training mode: MLM cross
    entropy over the labeled tokens (label -1 ignored), ITM cross entropy,
    10 x SmoothL1 (beta 1) of the T2I decoder against the clean images; all
    means. ``masked_input``: the masked images go in (odd steps). Over the
    ranks of a process ``group``, each holding an equal share of the global
    batch, the BatchNorm statistics are the global batch's and each rank's
    MLM term is its share of the global mean (its nll sum over the global
    labeled count, times the ranks), so that the ranks' average of each loss
    is the global batch's."""
    p = precision
    images = batch["masked_images"] if masked_input else batch["images"]
    feats, y = backbone(p, arch, sd, images.float(), batch["input_ids"].long(), Draws(generator))
    labels = batch["mlm_labels"].reshape(-1).long()
    keep = labels != -1
    rows = y.reshape(-1, y.shape[-1])[keep]
    hid = mlm_hidden(p, arch, sd, rows)
    logits = p.matmul(hid, sd["text_embeddings.word_embeddings.weight"].t()) + sd["mlm_head.bias"]
    nll = F.cross_entropy(logits, labels[keep], reduction="sum")
    if group is None:
        loss_mlm = nll / keep.sum().clamp(min=1)
    else:
        world = torch.distributed.get_world_size(group)
        total = _sum_ranks(keep.sum().float(), group).detach()
        loss_mlm = nll * world / total.clamp(min=1)
    loss_itm = F.cross_entropy(itm_logits(p, arch, sd, y), batch["itm_labels"].reshape(-1).long())
    loss_t2i = 10.0 * F.smooth_l1_loss(t2i_logits(p, arch, sd, feats, True, group),
                                       batch["images"].float(), beta=1.0)
    return {"loss_mlm": loss_mlm, "loss_itm": loss_itm, "loss_t2i": loss_t2i,
            "total_loss": loss_mlm + loss_itm + loss_t2i}


def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                 state: Dict[str, dict], step: int, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One decoupled-weight-decay Adam step in place (Loshchilov & Hutter):
    weight decay on tensors of more than one dimension only; ``step`` counts
    from 1."""
    b1, b2 = betas
    for name, prm in params.items():
        g = grads[name]
        st = state.setdefault(name, {"m": torch.zeros_like(prm), "v": torch.zeros_like(prm)})
        if prm.dim() > 1:
            prm.mul_(1.0 - lr * weight_decay)
        st["m"].mul_(b1).add_(g, alpha=1.0 - b1)
        st["v"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        m_hat = st["m"] / (1.0 - b1 ** step)
        denom = (st["v"] / (1.0 - b2 ** step)).sqrt().add_(eps)
        prm.addcdiv_(m_hat, denom, value=-lr)


def warmup_cosine_lr(step: int, peak: float, warmup_lr: float, min_lr: float,
                     warmup_steps: int, total_steps: int) -> float:
    """Linear warm-up from ``warmup_lr`` to ``peak`` over ``warmup_steps``,
    then a cosine to ``min_lr`` at ``total_steps``; ``step`` from 0."""
    warmup = max(1, warmup_steps)
    decay = max(warmup + 1, total_steps) - warmup
    if step < warmup:
        return warmup_lr + (peak - warmup_lr) * step / warmup
    t = min(step - warmup, decay) / decay
    return min_lr + (peak - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))
