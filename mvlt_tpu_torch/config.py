"""Configuration dataclasses of the port.

The port's own copy of the JAX package's ``LossType``, ``ModelConfig``,
``DataConfig``, ``OptimConfig`` and ``RunConfig``, and of the preset
machinery (``apply_overrides``, ``load_config_file``, ``config_to_dict``;
mvlt_tpu/config.py): the same fields, defaults and merge rules (every key
of a config file wins over the default), so a configuration means the same
thing on both sides; tests/test_torch_port_convert.py pins them equal. The
port reads ``fused_attn_train`` (a v1 block in training mode runs its
attention half as one fused call, ops/block_attention.py),
``fused_attn_stats`` (that call's saved-statistics backward) and ``remat``
(each block under torch.utils.checkpoint). Other fields
that steer the JAX package's TPU kernels (``block_attn_kernel``,
``pack_stage1``, ``head_pair_attn``, ``pack_mlp_train``,
``fused_mlp_train``, ``kernel_gelu``, ``dwconv_mlp_kernel``) are
kept for that equality and are not read by the port, which has exact-erf
GELU everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import runpy
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class LossType:
    """Which heads and objectives are active."""

    itm: bool = True
    mlm: bool = True
    t2i: bool = True
    cls: bool = False

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LossType":
        return cls(**{k: bool(v) for k, v in d.items() if k in {"itm", "mlm", "t2i", "cls"}})

    def to_dict(self) -> dict:
        return {"itm": int(self.itm), "mlm": int(self.mlm), "t2i": int(self.t2i),
                "cls": int(self.cls)}


@dataclass(frozen=True)
class ModelConfig:
    """PVLT architecture hyperparameters."""

    name: str = "pvlt_tiny"
    # built at 224 (pos-embed shapes of the published checkpoints), run at
    # DataConfig.input_size through a bilinear pos-embed resize
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dims: tuple = (64, 128, 320, 512)
    num_heads: tuple = (1, 2, 5, 8)
    mlp_ratios: tuple = (8, 8, 4, 4)
    depths: tuple = (2, 2, 2, 2)
    sr_ratios: tuple = (8, 4, 2, 1)
    qkv_bias: bool = True
    variant: str = "v1"
    linear_sr: bool = False
    window_size: int = 8
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    block_ln_eps: float = 1e-6
    other_ln_eps: float = 1e-5
    token_hidden_size: int = 768
    num_text_tokens: int = 128
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    bert_ln_eps: float = 1e-12
    bert_dropout: float = 0.1
    num_super_classes: int = 48
    num_sub_classes: int = 122
    itg_channel: int = 64
    loss_type: LossType = field(default_factory=LossType)
    compute_dtype: str = "bfloat16"
    use_pallas_attention: bool = True
    block_attn_kernel: str = "full"
    pack_stage1: bool = True
    head_pair_attn: bool = True
    pack_mlp_train: bool = True
    fused_mlp_train: bool = True
    fused_attn_train: bool = False
    fused_attn_stats: bool = False
    kernel_gelu: str = "tanh"
    dwconv_mlp_kernel: bool = True
    remat: bool = False
    # training computes the MLM CE in row chunks of this size (0: decode all)
    mlm_loss_chunk: int = 2048
    # decode only the labeled rows, gathered to this fraction of B*T
    mlm_capacity_frac: float = 0.16
    # the fused vocab-tiled MLM CE kernels on the card (ops/mlm_ce.py); the
    # CPU takes the chunked loss
    mlm_ce_kernel: bool = True

    @property
    def num_stages(self) -> int:
        return len(self.embed_dims)


@dataclass(frozen=True)
class DataConfig:
    """Fashion-Gen data and preprocessing."""

    data_path: str = ""
    data_set: str = "FashionGen"
    input_size: int = 256
    num_text_tokens: int = 128
    word_mask_rate: float = 0.15
    mask_ratio: float = 0.50
    mask_strategy: str = "random_grid"
    mask_patch_size: int = 16
    vocab_file: str = "preweights/bert-base-uncased-vocab.txt"
    repeated_aug: int = 3
    # the train split's images through the native crop-resize
    # (data/native.py); the valid split and the evals keep exact PIL
    use_native_image_ops: bool = True
    num_workers: int = 4
    prefetch_depth: int = 2
    synthetic: bool = False


@dataclass(frozen=True)
class OptimConfig:
    """AdamW with a warmup-cosine schedule."""

    opt: str = "adamw"
    lr: float = 2.5e-4
    min_lr: float = 1e-5
    warmup_lr: float = 1e-6
    warmup_epochs: int = 5
    weight_decay: float = 0.01
    clip_grad: float | None = None
    epochs: int = 150
    batch_size: int = 150
    lr_batch_denom: int = 512      # lr * global_batch / 512
    eps: float = 1e-8
    betas: tuple = (0.9, 0.999)


@dataclass(frozen=True)
class RunConfig:
    """Top-level experiment config."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    output_dir: str = ""
    seed: int = 0
    resume: str = ""
    finetune: str = ""
    eval_mode: str = ""            # '', 'vl', 'retrieval-itr', 'retrieval-tir', 'recognition'
    save_every_frac: float = 2.0 / 3.0  # checkpoint policy switch point (main_vl.py:444)
    log_every: int = 10
    # parallelism
    dp_size: int = -1              # -1: all devices on the data axis
    tp_size: int = 1


def _replace(dc, updates: Mapping[str, Any]):
    """dataclasses.replace that takes nested dict updates."""
    kwargs = {}
    for k, v in updates.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if isinstance(cur, LossType) and isinstance(v, Mapping):
            # before the generic dataclass branch (LossType is one): merge
            # with the current values and coerce ints to bools
            kwargs[k] = LossType.from_dict({**cur.to_dict(), **v})
        elif dataclasses.is_dataclass(cur) and isinstance(v, Mapping):
            kwargs[k] = _replace(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return dataclasses.replace(dc, **kwargs)


# Flat key -> nested path for reference-style config files
# (scripts_dws/configs/dws_mvlt_exp21.py uses a flat cfg dict).
_FLAT_KEYS = {
    "model": ("model", "name"),
    "input_size": ("data", "input_size"),
    "loss_type": ("model", "loss_type"),
    "batch_size": ("optim", "batch_size"),
    "epochs": ("optim", "epochs"),
    "lr": ("optim", "lr"),
    "weight_decay": ("optim", "weight_decay"),
    "clip_grad": ("optim", "clip_grad"),
    "drop_path": ("model", "drop_path_rate"),
    "mask_ratio": ("data", "mask_ratio"),
    "mask_strategy": ("data", "mask_strategy"),
    "mask_patch_size": ("data", "mask_patch_size"),
    "word_mask_rate": ("data", "word_mask_rate"),
    "output_dir": ("output_dir",),
    "data_set": ("data", "data_set"),
    "data_path": ("data", "data_path"),
    "seed": ("seed",),
    "resume": ("resume",),
    "finetune": ("finetune",),
    "pretrain_pth": ("finetune",),
    "num_text_tokens": ("model", "num_text_tokens"),
    "token_hidden_size": ("model", "token_hidden_size"),
    "num_workers": ("data", "num_workers"),
    "model_overrides": ("model",),   # nested ModelConfig dict
    "data_overrides": ("data",),
    "optim_overrides": ("optim",),
    # ignored vestigial reference keys
    "mixup": None,
    "cutmix": None,
}


def apply_overrides(cfg: RunConfig, flat: Mapping[str, Any]) -> RunConfig:
    """Apply a flat, reference-style config dict onto a RunConfig: every key
    wins over the current value (libs/utils.py:257-262)."""
    nested: dict = {}
    for k, v in flat.items():
        path = _FLAT_KEYS.get(k, (k,))
        if path is None:
            continue
        node = nested
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if isinstance(v, Mapping) and isinstance(node.get(path[-1]), dict) \
                and path[-1] not in ("loss_type",):
            node[path[-1]].update(v)   # merge model_overrides with e.g. model name
        else:
            node[path[-1]] = v
    out = _replace(cfg, nested)
    # keep dependent fields in sync (img_size is intentionally NOT synced to
    # input_size -- see ModelConfig.img_size)
    if out.model.num_text_tokens != out.data.num_text_tokens:
        out = _replace(out, {"data": {"num_text_tokens": out.model.num_text_tokens}})
    return out


def load_config_file(path: str | pathlib.Path, base: RunConfig | None = None) -> RunConfig:
    """Load an experiment preset: a ``.py`` file defining ``cfg = dict(...)``
    (the reference's format) or a ``.json`` file with the same flat keys."""
    base = base or RunConfig()
    path = pathlib.Path(path)
    if path.suffix == ".py":
        flat = runpy.run_path(str(path))["cfg"]
    elif path.suffix == ".json":
        flat = json.loads(path.read_text())
    else:
        raise ValueError(f"unsupported config format: {path.suffix}")
    return apply_overrides(base, flat)


def config_to_dict(cfg) -> dict:
    """A config tree as plain JSON values (checkpoint provenance)."""
    if isinstance(cfg, LossType):
        return cfg.to_dict()
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg
