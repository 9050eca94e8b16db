"""The weight bridge from the JAX package's parameter trees to the port.

The port's modules carry the reference's torch state-dict names, so a flax
``params`` tree (and ``batch_stats``), given as nested dicts of numpy arrays,
maps to a state dict that ``PVLT.load_state_dict(..., strict=True)`` takes;
a reference-format ``.pth`` loads as it is. The name mapping is the port's
own copy of mvlt_tpu/convert/torch_to_jax.py (``_MAPPING``, the skip list,
``_untransform`` and the strict export); tests/test_torch_port_convert.py
pins it to the original on a full pre-training model.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# torch name pattern -> (flax path template, kind); kinds: linear (transpose),
# conv (OIHW <-> HWIO), raw, bn_stat (a batch_stats leaf). First match wins.
_MAPPING: Tuple[Tuple[str, str, str], ...] = (
    (r"patch_embed(\d)\.proj\.weight", r"patch_embed\1/proj/kernel", "conv"),
    (r"patch_embed(\d)\.proj\.bias", r"patch_embed\1/proj/bias", "raw"),
    (r"patch_embed(\d)\.norm\.weight", r"patch_embed\1/norm/scale", "raw"),
    (r"patch_embed(\d)\.norm\.bias", r"patch_embed\1/norm/bias", "raw"),
    (r"text_embed(\d)\.0\.weight", r"text_embed\1_dense/kernel", "linear"),
    (r"text_embed(\d)\.0\.bias", r"text_embed\1_dense/bias", "raw"),
    (r"text_embed(\d)\.1\.weight", r"text_embed\1_ln/scale", "raw"),
    (r"text_embed(\d)\.1\.bias", r"text_embed\1_ln/bias", "raw"),
    (r"pos_embed(\d)", r"pos_embed\1", "raw"),
    (r"text_pos_embed(\d)", r"text_pos_embed\1", "raw"),
    (r"block(\d)\.(\d+)\.norm1\.weight", r"block\1_\2/norm1/scale", "raw"),
    (r"block(\d)\.(\d+)\.norm1\.bias", r"block\1_\2/norm1/bias", "raw"),
    (r"block(\d)\.(\d+)\.norm2\.weight", r"block\1_\2/norm2/scale", "raw"),
    (r"block(\d)\.(\d+)\.norm2\.bias", r"block\1_\2/norm2/bias", "raw"),
    (r"block(\d)\.(\d+)\.attn\.q\.weight", r"block\1_\2/attn/q/kernel", "linear"),
    (r"block(\d)\.(\d+)\.attn\.q\.bias", r"block\1_\2/attn/q/bias", "raw"),
    (r"block(\d)\.(\d+)\.attn\.kv\.weight", r"block\1_\2/attn/kv/kernel", "linear"),
    (r"block(\d)\.(\d+)\.attn\.kv\.bias", r"block\1_\2/attn/kv/bias", "raw"),
    (r"block(\d)\.(\d+)\.attn\.proj\.weight", r"block\1_\2/attn/proj/kernel", "linear"),
    (r"block(\d)\.(\d+)\.attn\.proj\.bias", r"block\1_\2/attn/proj/bias", "raw"),
    (r"block(\d)\.(\d+)\.attn\.sr\.weight", r"block\1_\2/attn/sr/kernel", "conv"),
    (r"block(\d)\.(\d+)\.attn\.sr\.bias", r"block\1_\2/attn/sr/bias", "raw"),
    (r"block(\d)\.(\d+)\.attn\.norm\.weight", r"block\1_\2/attn/norm/scale", "raw"),
    (r"block(\d)\.(\d+)\.attn\.norm\.bias", r"block\1_\2/attn/norm/bias", "raw"),
    (r"block(\d)\.(\d+)\.mlp\.fc1\.weight", r"block\1_\2/mlp/fc1/kernel", "linear"),
    (r"block(\d)\.(\d+)\.mlp\.fc1\.bias", r"block\1_\2/mlp/fc1/bias", "raw"),
    (r"block(\d)\.(\d+)\.mlp\.fc2\.weight", r"block\1_\2/mlp/fc2/kernel", "linear"),
    (r"block(\d)\.(\d+)\.mlp\.fc2\.bias", r"block\1_\2/mlp/fc2/bias", "raw"),
    (r"block(\d)\.(\d+)\.mlp\.dwconv\.dwconv\.weight",
     r"block\1_\2/mlp/dwconv/kernel", "conv"),
    (r"block(\d)\.(\d+)\.mlp\.dwconv\.dwconv\.bias",
     r"block\1_\2/mlp/dwconv/bias", "raw"),
    (r"block(\d)\.(\d+)\.attn\.relative_position_bias_table",
     r"block\1_\2/attn/rel_pos_bias", "raw"),
    (r"text_embeddings\.word_embeddings\.weight",
     r"text_embeddings/word_embeddings/embedding", "raw"),
    (r"text_embeddings\.position_embeddings\.weight",
     r"text_embeddings/position_embeddings/embedding", "raw"),
    (r"text_embeddings\.token_type_embeddings\.weight",
     r"text_embeddings/token_type_embeddings/embedding", "raw"),
    (r"text_embeddings\.LayerNorm\.weight", r"text_embeddings/LayerNorm/scale", "raw"),
    (r"text_embeddings\.LayerNorm\.bias", r"text_embeddings/LayerNorm/bias", "raw"),
    (r"(mlm|itm|sup_cls|sub_cls)_head_embed\.0\.weight", r"\1_head_embed_dense/kernel", "linear"),
    (r"(mlm|itm|sup_cls|sub_cls)_head_embed\.0\.bias", r"\1_head_embed_dense/bias", "raw"),
    (r"(mlm|itm|sup_cls|sub_cls)_head_embed\.1\.weight", r"\1_head_embed_ln/scale", "raw"),
    (r"(mlm|itm|sup_cls|sub_cls)_head_embed\.1\.bias", r"\1_head_embed_ln/bias", "raw"),
    (r"mlm_head\.transform\.dense\.weight", r"mlm_head/transform/dense/kernel", "linear"),
    (r"mlm_head\.transform\.dense\.bias", r"mlm_head/transform/dense/bias", "raw"),
    (r"mlm_head\.transform\.LayerNorm\.weight", r"mlm_head/transform/LayerNorm/scale", "raw"),
    (r"mlm_head\.transform\.LayerNorm\.bias", r"mlm_head/transform/LayerNorm/bias", "raw"),
    (r"mlm_head\.bias", r"mlm_head/bias", "raw"),
    (r"(itm|sup_cls|sub_cls)_head\.linear\.weight", r"\1_head/linear/kernel", "linear"),
    (r"(itm|sup_cls|sub_cls)_head\.linear\.bias", r"\1_head/linear/bias", "raw"),
    (r"(itm|sup_cls|sub_cls)_head\.linear_bias", r"\1_head/linear_bias", "raw"),
    # the T2I score conv precedes the generic ConvBN rows
    (r"t2i_head\.score\.0\.weight", r"t2i_head/score_conv/kernel", "conv"),
    (r"t2i_head\.score\.0\.bias", r"t2i_head/score_conv/bias", "raw"),
    (r"t2i_head\.(\w+)\.0\.weight", r"t2i_head/\1/conv/kernel", "conv"),
    (r"t2i_head\.(\w+)\.1\.weight", r"t2i_head/\1/bn/scale", "raw"),
    (r"t2i_head\.(\w+)\.1\.bias", r"t2i_head/\1/bn/bias", "raw"),
    (r"t2i_head\.(\w+)\.1\.running_mean", r"t2i_head/\1/bn/mean", "bn_stat"),
    (r"t2i_head\.(\w+)\.1\.running_var", r"t2i_head/\1/bn/var", "bn_stat"),
)

# reference keys with no flax counterpart
_SKIP_PATTERNS = (
    r"mlm_head\.mlm_decoder\.weight",   # tied to the word embeddings
    r"num_batches_tracked",
    r"text_embeddings\.position_ids",   # HF buffer
    r"^cls_token$", r"^norm\.", r"^head\.",  # PVT ImageNet-only leftovers
)

_GROUP = re.compile(r"\((?:[^()]|\([^()]*\))*\)")


def skipped(key: str) -> bool:
    """Whether a reference state-dict key has no parameter in the model."""
    return any(re.search(p, key) for p in _SKIP_PATTERNS)


def _untransform(kind: str, arr: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return arr.T
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)
    return arr


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)))
    return out


def _torch_key(path: str) -> Tuple[str, str] | None:
    """flax path 'a/b/c' -> (reference torch key, kind) by the first
    mapping row whose template matches."""
    for pat, tmpl, kind in _MAPPING:
        m = re.fullmatch(re.sub(r"\\(\d)", r"(\\w+)", tmpl), path)
        if m is None:
            continue
        key = pat
        for g in m.groups():
            key = _GROUP.sub(g.replace("\\", "\\\\"), key, count=1)
        return key.replace("\\.", "."), kind
    return None


def export_state_dict(params, batch_stats=None) -> Dict[str, np.ndarray]:
    """flax trees (numpy leaves) -> reference-named state dict of numpy
    arrays. Raises if any leaf has no reference name: an incomplete export
    must fail, not load as a partial model."""
    flat = _flatten(params)
    if batch_stats:
        flat.update(_flatten(batch_stats))
    out: Dict[str, np.ndarray] = {}
    unmapped = []
    for path, arr in flat.items():
        found = _torch_key("/".join(path))
        if found is None:
            unmapped.append("/".join(path))
            continue
        key, kind = found
        out[key] = _untransform(kind, arr)
    if unmapped:
        raise ValueError(f"export_state_dict: {len(unmapped)} parameters have no "
                         f"reference name: {sorted(unmapped)[:10]}")
    return out


def state_dict_from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (and ``batch_stats``) trees of numpy arrays ->
    reference-named torch state dict."""
    sd = export_state_dict(params, batch_stats)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}   # a writable copy
