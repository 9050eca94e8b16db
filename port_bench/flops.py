"""Model FLOPs from the configuration's shapes, and the byte count the op
counts share.

``forward_per_pair`` is the arithmetic of the repository's analytic count
(matrix products and convolutions, two FLOPs a multiply-add; elementwise
work, LayerNorm, softmax, GELU, upsampling and lookups left out), with
PVT-v2's linear SR added. Training counts the backward at twice the
forward, recomputes nothing, and decodes the MLM vocabulary for the
labeled rows only.
"""

from __future__ import annotations

from typing import Dict

LINEAR_SR_POOL = 7


def nbytes(*tensors) -> int:
    """Bytes of every tensor given (None counts 0), each read once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def linear_pool_rows(h: int, w: int) -> int:
    """The rows linear SR's average pool leaves of an h x w grid: windows of
    (h // p, w // p) with p = min(7, h, w), the last partial one dropped."""
    p = min(LINEAR_SR_POOL, h, w)
    wh, ww = max(1, h // p), max(1, w // p)
    return (h // wh) * (w // ww)


def stage_grids(m: dict, input_size: int) -> list:
    g = input_size // m["patch_size"]
    return [(g >> i, g >> i) for i in range(len(m["embed_dims"]))]


def forward_per_pair(m: dict, input_size: int) -> Dict[str, float]:
    """Forward FLOPs of one image-text pair by part: 'backbone' (with the
    ITM adapter and head), 'mlm_row' (one decoded text row: adapter,
    transform, vocabulary) and 't2i' (the pixel decoder)."""
    t = m["num_text_tokens"]
    th = m["token_hidden_size"]
    v2 = m.get("variant", "v1") == "v2"
    grids = stage_grids(m, input_size)
    f = 0.0
    prev_c, text_prev = 3, th
    for i, c in enumerate(m["embed_dims"]):
        h, w = grids[i]
        k = (7 if i == 0 else 3) if v2 else (m["patch_size"] if i == 0 else 2)
        n_img = h * w
        n = n_img + t
        sr = m["sr_ratios"][i]
        hidden = int(m["mlp_ratios"][i] * c)
        f += n_img * prev_c * k * k * c * 2                       # patch conv
        f += t * text_prev * c * 2                                # text re-projection
        for _ in range(m["depths"][i]):
            if m.get("linear_sr") and sr > 1:
                red = linear_pool_rows(h, w)
                f += red * c * c * 2                              # 1x1 SR conv
            elif sr > 1:
                red = n_img // (sr * sr)
                f += red * c * sr * sr * c * 2                    # SR conv
            else:
                red = n_img
            mm = red + t
            f += n * c * c * 2                                    # q
            f += mm * c * 2 * c * 2                               # kv
            f += 2 * n * mm * c * 2                               # q k^T and p v
            f += n * c * c * 2                                    # out projection
            f += 2 * n * c * hidden * 2                           # fc1, fc2
            if v2:
                f += n_img * hidden * 9 * 2                       # 3x3 depthwise conv
        prev_c = text_prev = c
    last = m["embed_dims"][-1]
    f += last * th * 2 + th * 2 * 2                               # ITM adapter and head
    mlm_row = last * th * 2 + th * th * 2 + th * m["vocab_size"] * 2
    ch = m["itg_channel"]
    t2i = 0.0
    for (sh, sw), sc in zip(grids[1:], m["embed_dims"][1:]):
        t2i += sh * sw * sc * 9 * ch * 2                          # reductions
    (h2, w2), (h3, w3) = grids[1], grids[2]
    t2i += h3 * w3 * ch * 9 * ch * 2 * 2                          # up1, up4
    t2i += h2 * w2 * ch * 9 * ch * 2 * 3                          # up2, up3
    t2i += h3 * w3 * (2 * ch) * 9 * (2 * ch) * 2                  # conv_concat2
    t2i += h2 * w2 * (2 * ch) * 9 * (2 * ch) * 2                  # conv_upsample5
    t2i += h2 * w2 * (3 * ch) * 9 * (3 * ch) * 2 * 2              # conv_concat3, conv4
    t2i += h2 * w2 * (3 * ch) * 3 * 2                             # 1x1 score conv
    return {"backbone": f, "mlm_row": float(mlm_row), "t2i": t2i}


def serve_flops(m: dict, input_size: int, pairs: int) -> float:
    """FLOPs of scoring ``pairs`` pairs with the ITM head alone."""
    return forward_per_pair(m, input_size)["backbone"] * pairs


def train_flops(m: dict, input_size: int, samples: int, labeled_rows: int) -> float:
    """FLOPs of training steps over ``samples`` samples whose batches hold
    ``labeled_rows`` MLM-labeled text rows: three times the forward of the
    backbone, the T2I decoder and the labeled rows' MLM decode."""
    f = forward_per_pair(m, input_size)
    return 3.0 * (samples * (f["backbone"] + f["t2i"]) + labeled_rows * f["mlm_row"])
