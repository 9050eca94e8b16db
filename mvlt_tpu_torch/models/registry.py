"""Model registry: name -> depth preset, config resolution and validation.

Mirrors mvlt_tpu/models/pvlt.py:MODEL_REGISTRY, resolve_model_config and
validate_model_config, which live in a module that imports JAX. The tests
pin these equal to the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from mvlt_tpu_torch.config import ModelConfig

MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    "pvlt_tiny": dict(depths=(2, 2, 2, 2)),
    "pvlt_small": dict(depths=(3, 4, 6, 3)),
    "pvlt_medium": dict(depths=(3, 4, 18, 3)),
    "pvlt_large": dict(depths=(3, 8, 27, 3)),
    "pvlt_v2_tiny": dict(depths=(2, 2, 2, 2), variant="v2"),
    "pvlt_v2_small": dict(depths=(3, 4, 6, 3), variant="v2"),
    "pvlt_v2_linear_tiny": dict(depths=(2, 2, 2, 2), variant="v2", linear_sr=True),
    "pvlt_swin_tiny": dict(depths=(2, 2, 2, 2), variant="swin"),
    "pvlt_swin_small": dict(depths=(2, 2, 6, 2), variant="swin"),
}


def validate_model_config(cfg: ModelConfig) -> None:
    """Reject unsupported knob combinations at construction time (the same
    checks as the JAX package)."""
    if cfg.attn_drop_rate and cfg.variant == "swin":
        raise NotImplementedError(
            f"attn_drop_rate={cfg.attn_drop_rate} is not supported by the "
            f"swin variant's window-attention path; use variant v1/v2 or "
            f"attn_drop_rate=0")
    if cfg.block_attn_kernel not in ("none", "mega", "auto", "full"):
        raise ValueError(
            f"block_attn_kernel={cfg.block_attn_kernel!r} not in "
            f"('none', 'mega', 'auto', 'full')")
    if cfg.kernel_gelu not in ("tanh", "erf"):
        raise ValueError(f"kernel_gelu={cfg.kernel_gelu!r} not in ('tanh', 'erf')")
    if not 0.0 < cfg.mlm_capacity_frac <= 1.0:
        raise ValueError(f"mlm_capacity_frac={cfg.mlm_capacity_frac} must be in (0, 1]")


def resolve_model_config(cfg: ModelConfig) -> ModelConfig:
    """cfg with the MODEL_REGISTRY preset for cfg.name applied: the config
    the model is actually built with."""
    if cfg.name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {cfg.name!r}; registry: {sorted(MODEL_REGISTRY)}")
    preset = MODEL_REGISTRY[cfg.name]
    updates = {k: v for k, v in preset.items() if getattr(cfg, k) != v}
    return dataclasses.replace(cfg, **updates) if updates else cfg
