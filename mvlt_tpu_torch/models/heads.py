"""Task heads: MLM (weight-tied), ITM, CLS and the T2I pixel decoder.

Counterparts of mvlt_tpu/models/heads.py (reference libs/vl_heads.py):
  * MLMHead: BertHeadTransform (dense, erf GELU, LayerNorm eps 1e-5), then a
    decoder tied to the word-embedding table passed in at call time, plus a
    free bias;
  * ITMHead / CLSHead: Linear plus a separate zero-initialised
    ``linear_bias``, both kept for checkpoint fidelity;
  * ITGHead: the FPN-style decoder over the stage 2-4 maps with
    multiplicative fusion, ConvBN blocks and align-corners upsampling; NHWC
    in and out.
BatchNorm follows flax's (the JAX package's) statistics: the batch variance
that normalises in training and enters the running variance is the biased
one, where torch.nn.BatchNorm2d keeps the unbiased one; momentum 0.1
(flax 0.9), eps 1e-5. Under data parallelism the training statistics are
those of the global batch, as in the JAX package's SPMD step: the sums are
all-reduced over the ranks with a gradient through the reduction, as
torch's SyncBatchNorm takes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.ops.kernel_math import acc_dtype, gelu, layer_norm_fp32, linear, matmul_acc
from mvlt_tpu_torch.ops.upsample import upsample_bilinear_align_corners
from mvlt_tpu_torch.parallel.sharding import all_reduce_sum, group_size
from mvlt_tpu_torch.parallel.tensor import VocabShardLogits, copy_to_model, vocab_start
from mvlt_tpu_torch.utils.profiling import annotate


class BertHeadTransform(nn.Module):
    def __init__(self, hidden_size: int = 768, ln_eps: float = 1e-5):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(linear(x, self.dense.weight, self.dense.bias))
        return layer_norm_fp32(x, self.LayerNorm.weight, self.LayerNorm.bias,
                               self.LayerNorm.eps)


class MLMHead(nn.Module):
    """Masked language modelling head; its decoder is the (tied) embedding
    table passed in at call time. Under tensor parallelism (a
    ``vocab_group`` passed in) the table and ``bias`` hold this rank's rows
    of the vocabulary."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768):
        super().__init__()
        self.transform = BertHeadTransform(hidden_size)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x: torch.Tensor, table: torch.Tensor, decode: bool = True,
                vocab_group=None):
        """x [B, T, hidden], table [vocab, hidden] -> fp32 logits
        [B, T, vocab]; with decode=False (hidden, bias) for the chunked loss.
        On a vocabulary split over ``vocab_group`` the decode is this rank's
        logits as a parallel/tensor.py:VocabShardLogits, whose nll and
        argmax combine the ranks' without gathering the logits (the eval),
        and whose ``local`` logits train through
        parallel/tensor.py:vocab_parallel_cross_entropy (train/losses.py);
        x enters the decode through ``copy_to_model``, so that its gradient
        sums every rank's vocabulary."""
        x = self.transform(x)
        if not decode:
            return x, self.bias
        if vocab_group is not None:
            x = copy_to_model(x, vocab_group)
        logits = matmul_acc(x, table.transpose(0, 1), x.dtype) + self.bias
        if vocab_group is None:
            return logits
        return VocabShardLogits(logits, vocab_start(table, vocab_group), vocab_group)


class ITMHead(nn.Module):
    """Image-text matching head (2-way); CLSHead with two classes."""

    def __init__(self, hidden_size: int = 768, num_classes: int = 2):
        super().__init__()
        self.linear = nn.Linear(hidden_size, num_classes)
        self.linear_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = linear(x, self.linear.weight, self.linear.bias)
        return y + self.linear_bias.to(y.dtype)


class CLSHead(ITMHead):
    """Super/sub-category recognition head."""

    def __init__(self, num_classes: int, hidden_size: int = 768):
        super().__init__(hidden_size, num_classes)


class BatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW map with flax's statistics
    (biased batch variance); state-dict names of torch's BatchNorm2d
    without ``num_batches_tracked``. With a process ``group`` of more than
    one rank (set by parallel/sharding.py:wrap_model) the training
    statistics are taken over every rank's batch."""

    group = None

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def batch_stats(self, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, biased variance) per channel of the batch: this rank's, or
        over all ranks of ``group``, two passes either way. Across ranks the
        sums (and the element count) are all-reduced, the second pass
        around the global mean; the reductions' backward sums the ranks'
        gradients, so each rank's loss reaches every rank's input."""
        if group_size(self.group) == 1:
            mean = xf.mean((0, 2, 3))
            return mean, (xf - mean[:, None, None]).square().mean((0, 2, 3))
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        with annotate("mvlt.sync.bn"):
            sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), count]), self.group,
                                  differentiable=True)
            mean = sums[:-1] / sums[-1]
            dev = all_reduce_sum((xf - mean[:, None, None]).square().sum((0, 2, 3)), self.group,
                                 differentiable=True)
        return mean, dev / sums[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = acc_dtype(x.dtype)
        xf = x.to(acc)
        if self.training:
            mean, var = self.batch_stats(xf)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        else:
            mean, var = self.running_mean.to(acc), self.running_var.to(acc)
        scale = self.weight.to(acc) * torch.rsqrt(var + self.eps)
        shift = self.bias.to(acc) - mean * scale
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class ConvBN(nn.Sequential):
    """Conv (no bias, 3x3 pad 1 unless given) then BatchNorm; NHWC in and
    out (the conv runs on the channels-last view, no copy)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, padding: int = 1):
        super().__init__(nn.Conv2d(cin, cout, kernel_size, padding=padding, bias=False),
                         BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self[0], self[1]
        y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), padding=conv.padding)
        return bn(y).permute(0, 2, 3, 1)


class ITGHead(nn.Module):
    """T2I pixel decoder: stage 2-4 maps (NHWC) -> [B, H, W, 3] at the input
    resolution (x8 of stage 2)."""

    def __init__(self, embed_dims=(64, 128, 320, 512), channel: int = 64):
        super().__init__()
        c = channel
        self.reduction1 = ConvBN(embed_dims[1], c)
        self.reduction2 = ConvBN(embed_dims[2], c)
        self.reduction3 = ConvBN(embed_dims[3], c)
        self.conv_upsample1 = ConvBN(c, c)
        self.conv_upsample2 = ConvBN(c, c)
        self.conv_upsample3 = ConvBN(c, c)
        self.conv_upsample4 = ConvBN(c, c)
        self.conv_upsample5 = ConvBN(2 * c, 2 * c)
        self.conv_concat2 = ConvBN(2 * c, 2 * c)
        self.conv_concat3 = ConvBN(3 * c, 3 * c)
        self.conv4 = ConvBN(3 * c, 3 * c)
        self.score = nn.Sequential(nn.Conv2d(3 * c, 3, 1))

    def forward(self, low_feat, mid_feat, high_feat) -> torch.Tensor:
        up2 = lambda t: upsample_bilinear_align_corners(t, 2)
        low = self.reduction1(low_feat)
        mid = self.reduction2(mid_feat)
        high = self.reduction3(high_feat)
        x2_1 = self.conv_upsample1(up2(high)) * mid
        x3_1 = self.conv_upsample2(up2(mid)) * self.conv_upsample3(up2(x2_1)) * low
        x2_2 = self.conv_concat2(torch.cat([x2_1, self.conv_upsample4(up2(high))], dim=-1))
        x3_2 = self.conv_concat3(torch.cat([x3_1, self.conv_upsample5(up2(x2_2))], dim=-1))
        refined = self.conv4(x3_2)
        # the 1x1 score conv as a product over the NHWC channels: a conv on
        # the channels-last view gives its weight a channels-last gradient,
        # whose strides differ from the parameter's in the size-1 dims, and
        # DDP then warns on every step that they differ from its bucket view
        conv = self.score[0]
        w = conv.weight.to(refined.dtype)
        score = F.linear(refined, w.reshape(w.shape[0], -1), conv.bias.to(refined.dtype))
        return upsample_bilinear_align_corners(score, 8)
