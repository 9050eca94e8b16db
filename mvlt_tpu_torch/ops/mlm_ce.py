"""MLM cross entropy against the tied vocabulary:
    nll[r] = logsumexp(x E^T + b)[r] - (x E^T + b)[r, label[r]]
for rows x [R, H], the tied word-embedding table E [V, H], the decoder bias
b [V] and labels [R], -1 ignored (0 nll, 0 gradient). The forward never
writes the [R, V] logits to device memory; the backward recomputes them
once and writes their gradient dl once, in bf16, to a [R, V] scratch
rounded up to 128 (188 MB at R = 3,072, V = 30,522) that its two products
read.

Counterpart of mvlt_tpu/ops/mlm_ce.py:fused_mlm_nll (forward ``_fwd_impl``,
backward ``_bwd_impl``) and ``fused_mlm_loss``. The plain versions are
``mlm_nll_reference`` and ``mlm_nll_bwd_reference``; the latter recomputes
the logits from the saved logsumexp as the kernels do. ``mlm_ce_fwd`` and
``mlm_ce_bwd`` take them for CPU tensors and launch the Hopper kernels
(csrc/mlm_ce.cu, on wgmma) for CUDA tensors, or raise; ``mlm_nll`` is the
differentiable ``autograd.Function``. It takes the fp32 master table, rounds
it to the rows' type once in the forward, and returns fp32 gradients for the
table and the bias.

Tensor-parallel mode (``mlm_ce_fwd_tp``, ``mlm_ce_bwd_tp``; plain versions
``mlm_nll_partial_reference`` and ``mlm_nll_bwd_reference(vocab_start=)``):
the table and bias are a rank's rows [vocab_start, vocab_start + V) of the
vocabulary and the labels stay global. The forward gives the rank's (lse,
picked logit; 0 where the label lies outside its range), the backward takes
the model group's lse and gives the rank's partial d_rows beside its own
d_table and d_bias (parallel/tensor.py:vocab_parallel_nll combines them).
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, matmul_acc

# both directions stream the width in 64-deep chunks; widths up to 768, the
# one the JAX kernel's VMEM tiles are sized for (mvlt_tpu/ops/mlm_ce.py:54)
MAX_WIDTH = 768
WIDTH_MULTIPLE = 64
# the kernels' output tiles (csrc/hopper.cuh: kGemmTile, kGemmChunk)
BWD_TILE = 128
BWD_CHUNK = 64
MAX_SPLITS = 16


def _logits(rows, table, bias):
    """x E^T + b with the product's operands in rows.dtype and its sum, the
    bias and the result in fp32 (fp64 for fp64)."""
    return matmul_acc(rows, table.transpose(0, 1), rows.dtype) + bias.to(acc_dtype(rows.dtype))


def mlm_nll_reference(rows, table, bias, labels):
    """Plain forward: (nll [R], lse [R]) in fp32 (fp64 for fp64 rows)."""
    logits = _logits(rows, table, bias)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    picked = logits.gather(-1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
    return torch.where(valid, lse - picked, 0.0), lse


def _local_labels(labels, vocab_start: int, vocab: int):
    """(the label's column in the table's rows, whether it lies there)."""
    local = labels.long() - vocab_start
    inside = (labels >= 0) & (local >= 0) & (local < vocab)
    return torch.where(inside, local, 0), inside


def mlm_nll_partial_reference(rows, table, bias, labels, vocab_start: int):
    """Plain forward of the tensor-parallel mode on the table's rows
    [vocab_start, vocab_start + V): (lse [R], picked [R]) of this range in
    fp32 (fp64 for fp64 rows), picked 0 where the label lies elsewhere or
    is ignored."""
    logits = _logits(rows, table, bias)
    local, inside = _local_labels(labels, vocab_start, table.shape[0])
    picked = torch.where(inside, logits.gather(-1, local[:, None])[:, 0], 0.0)
    return torch.logsumexp(logits, dim=-1), picked


def mlm_nll_bwd_reference(rows, table, bias, labels, lse, g, vocab_start: int = 0):
    """Plain backward for the per-row output gradient g: (d_rows, d_table,
    d_bias) in fp32 (fp64 for fp64 rows), the logits recomputed from lse;
    dl is rounded to rows.dtype before its two products, as in the kernels.
    With ``vocab_start`` (the tensor-parallel mode) the table is the rows
    from there on, lse the whole vocabulary's and d_rows this range's
    partial."""
    acc = acc_dtype(rows.dtype)
    dl = torch.exp(_logits(rows, table, bias) - lse.to(acc)[:, None])
    valid = labels >= 0
    local, inside = _local_labels(labels, vocab_start, table.shape[0])
    dl[torch.arange(rows.shape[0], device=rows.device), local] -= inside.to(acc)
    dl = torch.where(valid[:, None], g.to(acc)[:, None] * dl, 0.0)
    return (matmul_acc(dl, table, rows.dtype), matmul_acc(dl.transpose(0, 1), rows, rows.dtype),
            dl.sum(0))


def _check(name: str, rows, table, bias, labels):
    """Shapes, devices and types the kernels take; returns the operands as
    they read them (bf16 rows and table, fp32 bias, int32 labels)."""
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {rows.device}")
    if rows.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16 rows only, got {rows.dtype}")
    if rows.dim() != 2 or not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError(f"{name}: expected contiguous, 16-byte aligned [R, H] rows, "
                         f"got shape {tuple(rows.shape)}")
    r, h = rows.shape
    if h % WIDTH_MULTIPLE or not 0 < h <= MAX_WIDTH:
        raise ValueError(f"{name}: width {h} must be a multiple of {WIDTH_MULTIPLE} "
                         f"and <= {MAX_WIDTH}")
    if tuple(labels.shape) != (r,) or labels.device != rows.device:
        raise ValueError(f"{name}: labels {tuple(labels.shape)} on {labels.device}, "
                         f"expected ({r},) on {rows.device}")
    v = table.shape[0]
    return (_build.kernel_weight(name, table, (v, h), rows.device),
            _build.kernel_vector(name, bias, v, rows.device),
            labels.to(torch.int32).contiguous())


def _up(n: int, tile: int) -> int:
    return -(-n // tile) * tile


def fwd_partials(rows: int, vocab: int) -> tuple[int, int]:
    """(vocab_tiles, floats) of the forward's partials: one (max, sum of
    exp, picked) per row and 128-column vocabulary tile, [vocab_tiles, rows,
    3] fp32, merged in vocabulary order by the second launch."""
    tiles = _up(vocab, BWD_TILE) // BWD_TILE
    return tiles, tiles * rows * 3


def bwd_plan(rows: int, vocab: int, width: int, sms: int) -> tuple[int, int, int]:
    """(rows_pad, vocab_pad, splits) of the backward: rows and vocabulary
    rounded up to its 128 tile, and the vocabulary ranges of dx, the fewest
    whose (width tile, row tile, range) blocks, one an SM, fill at least 90%
    of their last wave on ``sms`` SMs (else the fullest), trimmed so that
    no range is empty."""
    rows_pad, vocab_pad = _up(rows, BWD_TILE), _up(vocab, BWD_TILE)
    tiles = _up(width, BWD_TILE) // BWD_TILE * (rows_pad // BWD_TILE)
    return rows_pad, vocab_pad, _build.split_plan(tiles, vocab_pad // BWD_CHUNK, sms, MAX_SPLITS)


def _fwd_launch(name: str, rows, table, bias, labels, vocab_start: int, partial: bool = False):
    """The forward's kernels on a CUDA tensor: (nll, lse), with ``partial``
    (picked, lse)."""
    tab, b, lab = _check(name, rows, table, bias, labels)
    r, h = rows.shape
    v = tab.shape[0]
    dev = rows.device
    lib = _build.load_library()
    ws = torch.empty(fwd_partials(r, v)[1], dtype=torch.float32, device=dev)
    nll = torch.empty(r, dtype=torch.float32, device=dev)
    lse = torch.empty(r, dtype=torch.float32, device=dev)
    err = lib.mvlt_mlm_ce_fwd(rows.data_ptr(), tab.data_ptr(), b.data_ptr(), lab.data_ptr(),
                              ws.data_ptr(), nll.data_ptr(), lse.data_ptr(), r, v, h,
                              vocab_start, int(partial),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    return nll, lse


def mlm_ce_fwd(rows, table, bias, labels):
    """Forward (nll, lse). A CPU tensor takes ``mlm_nll_reference``; a CUDA
    tensor launches the kernel (and its merge of the vocabulary tiles'
    partials), anything else raises. Counts launches in
    ``mlm_ce_fwd.launches``."""
    if rows.device.type == "cpu":
        return mlm_nll_reference(rows, table, bias, labels)
    out = _fwd_launch("mlm_ce_fwd", rows, table, bias, labels, 0)
    mlm_ce_fwd.launches += 1
    return out


def mlm_ce_fwd_tp(rows, table, bias, labels, vocab_start: int):
    """The forward's tensor-parallel mode on the table's rows from
    ``vocab_start``: (lse, picked) of the range. A CPU tensor takes
    ``mlm_nll_partial_reference``; a CUDA tensor launches the kernels,
    anything else raises. Counts launches in ``mlm_ce_fwd_tp.launches``."""
    if rows.device.type == "cpu":
        return mlm_nll_partial_reference(rows, table, bias, labels, vocab_start)
    nll_or_picked, lse = _fwd_launch("mlm_ce_fwd_tp", rows, table, bias, labels, vocab_start,
                                     partial=True)
    mlm_ce_fwd_tp.launches += 1
    return lse, nll_or_picked


def _bwd_launch(name: str, rows, table, bias, labels, lse, g, vocab_start: int):
    """The backward's kernels on a CUDA tensor."""
    tab, b, lab = _check(name, rows, table, bias, labels)
    r, h = rows.shape
    v = tab.shape[0]
    dev = rows.device
    per_row = [t.to(torch.float32).contiguous() for t in (lse, g)]
    if any(tuple(t.shape) != (r,) or t.device != dev for t in per_row):
        raise ValueError(f"{name}: lse and g must be [{r}] on {dev}")
    lib = _build.load_library()
    rows_pad, vocab_pad, splits = bwd_plan(r, v, h, _build.sm_count(dev.index))
    f32 = dict(dtype=torch.float32, device=dev)
    dl = torch.empty(rows_pad * vocab_pad, dtype=torch.bfloat16, device=dev)
    dbp = torch.empty(rows_pad // BWD_TILE * vocab_pad, **f32)
    slots = torch.empty(splits * r * h if splits > 1 else 1, **f32)
    d_rows = torch.empty((r, h), **f32)
    d_table = torch.empty((v, h), **f32)
    d_bias = torch.empty(v, **f32)
    err = lib.mvlt_mlm_ce_bwd(rows.data_ptr(), tab.data_ptr(), b.data_ptr(), lab.data_ptr(),
                              per_row[0].data_ptr(), per_row[1].data_ptr(), dl.data_ptr(),
                              dbp.data_ptr(), slots.data_ptr(), d_rows.data_ptr(),
                              d_table.data_ptr(), d_bias.data_ptr(), r, v, h, splits,
                              vocab_start, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    return d_rows, d_table, d_bias


def mlm_ce_bwd(rows, table, bias, labels, lse, g):
    """Backward (d_rows, d_table, d_bias), all fp32. A CPU tensor takes
    ``mlm_nll_bwd_reference``; a CUDA tensor launches the kernels (dl, the
    db sum, dx with its range sum, dE), anything else raises. Counts
    launches in ``mlm_ce_bwd.launches``."""
    if rows.device.type == "cpu":
        return mlm_nll_bwd_reference(rows, table, bias, labels, lse, g)
    out = _bwd_launch("mlm_ce_bwd", rows, table, bias, labels, lse, g, 0)
    mlm_ce_bwd.launches += 1
    return out


def mlm_ce_bwd_tp(rows, table, bias, labels, lse, g, vocab_start: int):
    """The backward's tensor-parallel mode: lse the model group's, the
    table's rows from ``vocab_start``; (the range's partial d_rows, its
    d_table, its d_bias), all fp32. A CPU tensor takes
    ``mlm_nll_bwd_reference(vocab_start=)``; a CUDA tensor launches the
    kernels, anything else raises. Counts launches in
    ``mlm_ce_bwd_tp.launches``."""
    if rows.device.type == "cpu":
        return mlm_nll_bwd_reference(rows, table, bias, labels, lse, g, vocab_start)
    out = _bwd_launch("mlm_ce_bwd_tp", rows, table, bias, labels, lse, g, vocab_start)
    mlm_ce_bwd_tp.launches += 1
    return out


mlm_ce_fwd.launches = 0
mlm_ce_bwd.launches = 0
mlm_ce_fwd_tp.launches = 0
mlm_ce_bwd_tp.launches = 0


class _MlmNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, table, bias, labels):
        table_c = table.detach().to(rows.dtype)   # rounded once for both directions
        nll, lse = mlm_ce_fwd(rows, table_c, bias, labels)
        ctx.dtypes = (rows.dtype, table.dtype, bias.dtype)
        ctx.save_for_backward(rows, table_c, bias, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        rows, table_c, bias, labels, lse = ctx.saved_tensors
        grads = mlm_ce_bwd(rows, table_c, bias, labels, lse, g)
        return (*(d.to(t) for d, t in zip(grads, ctx.dtypes)), None)


def mlm_nll(rows, table, bias, labels):
    """Per-row nll of rows [R, H] against table [V, H] + bias [V], labels
    [R] (-1 ignored), differentiable in rows, table and bias: the kernels on
    CUDA tensors, their plain versions on CPU tensors."""
    return _MlmNll.apply(rows, table, bias, labels)


def mlm_ce_loss(hidden, table, bias, labels):
    """Mean nll over the labeled rows (0 when none is), as
    mvlt_tpu/ops/mlm_ce.py:fused_mlm_loss: hidden [..., H], labels [...]."""
    rows = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    labs = labels.reshape(-1)
    nll = mlm_nll(rows, table, bias, labs)
    return nll.sum() / (labs >= 0).sum().clamp(min=1)
