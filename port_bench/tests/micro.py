"""Cells cut down to a size the CPU runs in seconds, for the tests: the
same configuration files and mixes with small widths, images and text.
"""

from __future__ import annotations

import time

import torch

from port_bench import common

MICRO_MODEL = dict(embed_dims=[16, 32, 40, 64], token_hidden_size=32, vocab_size=1100,
                   num_text_tokens=8, compute_dtype="float32", itg_channel=8)
TEXT = dict(text_tokens=8, caption_pieces=[2, 6], piece_ids=[999, 1100])
NUMBERS = {"retrieval": ("score_gap", "rank_miss")}


def config(name: str) -> dict:
    cfg = common.config(name)
    cfg["model"].update(MICRO_MODEL)
    cfg["input_size"] = 64
    return cfg


def mix(name: str) -> dict:
    m = common.traffic(name)
    m.update(TEXT, image_size=64)
    m.update(candidates=5, pool_items=3, trace_skip_calls=2, trace_calls=2, check_calls=2)
    return m


def context(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0, fault=None,
            control: bool = False, limit: float = 1e-3):
    """A CPU context of the cell ``workload`` at the micro size, every
    number's limit ``limit``."""
    c = common.find(common.benchmark()["workloads"], workload, "workload")
    m = mix(c["traffic"])
    lim = {"numbers": {k: {"limit": limit} for k in NUMBERS[m["driver"]]}}
    return common.Context(c, config(c["config"]), m, lim, seed, seconds, False,
                          torch.device("cpu"), time.time(), fault=fault, control=control)
