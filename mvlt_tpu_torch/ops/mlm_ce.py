"""MLM cross entropy against the tied vocabulary, the [rows, vocab] logits
never in device memory:
    nll[r] = logsumexp(x E^T + b)[r] - (x E^T + b)[r, label[r]]
for rows x [R, H], the tied word-embedding table E [V, H], the decoder bias
b [V] and labels [R], -1 ignored (0 nll, 0 gradient).

Counterpart of mvlt_tpu/ops/mlm_ce.py:fused_mlm_nll (forward ``_fwd_impl``,
backward ``_bwd_impl``) and ``fused_mlm_loss``. The plain versions are
``mlm_nll_reference`` and ``mlm_nll_bwd_reference``; the latter recomputes
the logits from the saved logsumexp as the kernels do. ``mlm_ce_fwd`` and
``mlm_ce_bwd`` take them for CPU tensors and launch the Hopper kernels
(csrc/mlm_ce.cu) for CUDA tensors, or raise; ``mlm_nll`` is the
differentiable ``autograd.Function``. It takes the fp32 master table, rounds
it to the rows' type once in the forward, and returns fp32 gradients for the
table and the bias.
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, matmul_acc

# shared memory holds a 64-row tile of x and of E, each of the whole width
MAX_WIDTH = 768


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


def mlm_nll_bwd_reference(rows, table, bias, labels, lse, g):
    """Plain backward for the per-row output gradient g: (d_rows, d_table,
    d_bias) in fp32 (fp64 for fp64 rows), the logits recomputed from lse;
    dl is rounded to rows.dtype before its two products, as in the kernels."""
    acc = acc_dtype(rows.dtype)
    dl = torch.exp(_logits(rows, table, bias) - lse.to(acc)[:, None])
    valid = labels >= 0
    dl[torch.arange(rows.shape[0], device=rows.device), torch.where(valid, labels, 0).long()] -= 1.0
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
    if h % 16 or h > MAX_WIDTH:
        raise ValueError(f"{name}: width {h} must be a multiple of 16 and <= {MAX_WIDTH}")
    if tuple(labels.shape) != (r,) or labels.device != rows.device:
        raise ValueError(f"{name}: labels {tuple(labels.shape)} on {labels.device}, "
                         f"expected ({r},) on {rows.device}")
    v = table.shape[0]
    return (_build.kernel_weight(name, table, (v, h), rows.device),
            _build.kernel_vector(name, bias, v, rows.device),
            labels.to(torch.int32).contiguous())


def _splits(lib, rows: int, vocab: int, device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return lib.mvlt_mlm_ce_splits(rows, vocab, sms)


def mlm_ce_fwd(rows, table, bias, labels):
    """Forward (nll, lse). A CPU tensor takes ``mlm_nll_reference``; a CUDA
    tensor launches the kernel (and its merge of the vocabulary splits),
    anything else raises. Counts launches in ``mlm_ce_fwd.launches``."""
    if rows.device.type == "cpu":
        return mlm_nll_reference(rows, table, bias, labels)
    name = "mlm_ce_fwd"
    tab, b, lab = _check(name, rows, table, bias, labels)
    r, h = rows.shape
    v = tab.shape[0]
    dev = rows.device
    lib = _build.load_library()
    splits = _splits(lib, r, v, dev)
    ws = torch.empty(splits * r * 3, dtype=torch.float32, device=dev)
    nll = torch.empty(r, dtype=torch.float32, device=dev)
    lse = torch.empty(r, dtype=torch.float32, device=dev)
    err = lib.mvlt_mlm_ce_fwd(rows.data_ptr(), tab.data_ptr(), b.data_ptr(), lab.data_ptr(),
                              ws.data_ptr(), nll.data_ptr(), lse.data_ptr(), r, v, h, splits,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    mlm_ce_fwd.launches += 1
    return nll, lse


def mlm_ce_bwd(rows, table, bias, labels, lse, g):
    """Backward (d_rows, d_table, d_bias), all fp32. A CPU tensor takes
    ``mlm_nll_bwd_reference``; a CUDA tensor launches the kernels (dx with
    its slot reduction, then dE and db), anything else raises. Counts
    launches in ``mlm_ce_bwd.launches``."""
    if rows.device.type == "cpu":
        return mlm_nll_bwd_reference(rows, table, bias, labels, lse, g)
    name = "mlm_ce_bwd"
    tab, b, lab = _check(name, rows, table, bias, labels)
    r, h = rows.shape
    v = tab.shape[0]
    dev = rows.device
    per_row = [t.to(torch.float32).contiguous() for t in (lse, g)]
    if any(tuple(t.shape) != (r,) or t.device != dev for t in per_row):
        raise ValueError(f"{name}: lse and g must be [{r}] on {dev}")
    lib = _build.load_library()
    tile = lib.mvlt_mlm_ce_tile()
    splits = _splits(lib, r, v, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ws = torch.empty(splits * -(-r // tile) * tile * h, **f32)
    d_rows = torch.empty((r, h), **f32)
    d_table = torch.empty((-(-v // tile) * tile, h), **f32)
    d_bias = torch.empty(v, **f32)
    err = lib.mvlt_mlm_ce_bwd(rows.data_ptr(), tab.data_ptr(), b.data_ptr(), lab.data_ptr(),
                              per_row[0].data_ptr(), per_row[1].data_ptr(), ws.data_ptr(),
                              d_rows.data_ptr(), d_table.data_ptr(), d_bias.data_ptr(), r, v, h,
                              splits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    mlm_ce_bwd.launches += 1
    return d_rows, d_table[:v], d_bias


mlm_ce_fwd.launches = 0
mlm_ce_bwd.launches = 0


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
