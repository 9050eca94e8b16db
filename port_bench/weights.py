"""Weights made from the seed, on the device, in a few large draws.

One standard normal draw covers every tensor that is drawn; each takes its
slice, scaled and shifted by its rule (below). Every number the kernels
read is drawn, so that a kernel that drops or misplaces one serves other
scores. Linear and conv weights are LeCun normal over their fan-in,
truncated at two scales (clamped here), and twice that for the attention's
q and kv products, which gives attention logits a spread of about 3, as a
trained model's, and not the near-uniform softmax of small weights; the
T2I decoder's 3x3 convs He normal over fan-out; embedding and positional
tables 0.02 (the embeddings are LayerNormed after). Every bias and every
LayerNorm or BatchNorm shift is N(0, 0.1), and every such scale
1 + N(0, 0.1); BatchNorm's running mean 0 and variance 1. The benchmark
hands the same dict to the program (``load_state_dict``) and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _rule(name: str, shape: tuple) -> tuple:
    """(kind, scale, shift) for one tensor: kind 'normal', 'trunc', 'zeros'
    or 'ones'; a drawn tensor is shift + scale x its draw."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean" or leaf == "num_batches_tracked":
        return "zeros", 0.0, 0.0
    if leaf == "running_var":
        return "ones", 0.0, 0.0
    if "pos_embed" in name:
        return "trunc", 0.02, 0.0
    if len(shape) <= 1:
        # every 1-D ``weight`` of PVLT is a LayerNorm or BatchNorm scale
        return ("normal", 0.1, 1.0) if leaf == "weight" else ("normal", 0.1, 0.0)
    if "embeddings" in name:
        return "normal", 0.02, 0.0
    if name.startswith("t2i_head.") and len(shape) == 4 and name != "t2i_head.score.0.weight":
        fan_out = shape[0] * shape[2] * shape[3]
        return "normal", math.sqrt(2.0 / fan_out), 0.0
    gain = 2.0 if name.endswith(("attn.q.weight", "attn.kv.weight")) else 1.0
    return "trunc", gain * math.prod(shape[1:]) ** -0.5, 0.0


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name in ``shapes`` from ``seed``, on ``device``."""
    rules = {n: _rule(n, tuple(s)) for n, s in shapes.items()}
    drawn = [n for n, (kind, _, _) in rules.items() if kind in ("normal", "trunc")]
    total = sum(math.prod(shapes[n]) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind, scale, shift = rules[name]
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            t = flat[at: at + n]
            at += n
            if kind == "trunc":
                t = t.clamp(-2.0, 2.0)
            out[name] = (t * scale + shift).reshape(shape)
    return out
