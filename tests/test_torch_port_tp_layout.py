"""The tensor-parallel layout of the port (parallel/tensor.py:RULES), on the
CPU without a process group.

Which tensors split at tp = 2 and 4 is pinned for pvlt_tiny, the micro
config of tests/test_train_step.py, pvlt_large, pvlt_v2_tiny,
pvlt_v2_linear_tiny and pvlt_swin_tiny (their state-dict names from models
built on the meta device): an attention splits by whole heads only where
the stage's heads divide by tp (the 1/2/5/8 heads: stages 2 and 4 at tp =
2, stage 4 at tp = 4), Swin's relative-position tables by their head
columns with it, every MLP hidden at both, v2's depthwise conv by its
channels with it, the vocabulary of 30,522 at tp = 2 only; nothing else
splits (linear SR's front end, Swin's text pooling). ``shard_state_dict``
then the ranks' ``placed_state`` (what ``consolidate`` sums over the model
group) give back every tensor exactly with the same names, and a shard's
K/V rows are its heads' K rows then their V rows, against an index written
out by hand.
"""

import dataclasses

import pytest
import torch

from mvlt_tpu_torch import config
from mvlt_tpu_torch.models.pvlt import PVLT, create_model
from mvlt_tpu_torch.models.registry import resolve_model_config
from mvlt_tpu_torch.ops.sr_kv import split_kv
from mvlt_tpu_torch.parallel.tensor import (COL, KV, ROW, layout, placed_state,
                                            shard_state_dict, shard_tensor)
from tests.test_torch_port_train import MICRO, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

HEADS = config.LossType(itm=True, mlm=True, t2i=True, cls=True)
CONFIGS = {
    "pvlt_tiny": config.ModelConfig(name="pvlt_tiny", loss_type=HEADS),
    "micro": config.ModelConfig(**MICRO, loss_type=HEADS),
    "pvlt_large": config.ModelConfig(name="pvlt_large", loss_type=HEADS),
    "pvlt_v2_tiny": config.ModelConfig(name="pvlt_v2_tiny", loss_type=HEADS),
    "pvlt_v2_linear_tiny": config.ModelConfig(name="pvlt_v2_linear_tiny", loss_type=HEADS),
    "pvlt_swin_tiny": config.ModelConfig(name="pvlt_swin_tiny", loss_type=HEADS),
}
# (stages whose attention splits, whether the vocabulary splits) by tp;
# every stage's MLP hidden splits at both
EXPECTED = {
    ("pvlt_tiny", 2): ({2, 4}, True), ("pvlt_tiny", 4): ({4}, False),
    ("micro", 2): ({2, 3, 4}, True), ("micro", 4): ({4}, True),
    ("pvlt_large", 2): ({2, 4}, True), ("pvlt_large", 4): ({4}, False),
    ("pvlt_v2_tiny", 2): ({2, 4}, True), ("pvlt_v2_tiny", 4): ({4}, False),
    ("pvlt_v2_linear_tiny", 2): ({2, 4}, True), ("pvlt_v2_linear_tiny", 4): ({4}, False),
    ("pvlt_swin_tiny", 2): ({2, 4}, True), ("pvlt_swin_tiny", 4): ({4}, False),
}


def _names(cfg) -> list:
    with torch.device("meta"):
        return list(PVLT(resolve_model_config(cfg)).state_dict())


@pytest.mark.parametrize("name,tp", sorted(EXPECTED))
def test_rule_table(name, tp):
    cfg = resolve_model_config(CONFIGS[name])
    names = _names(cfg)
    split = layout(names, cfg, tp)
    attn, vocab = EXPECTED[(name, tp)]
    want = {}
    for s, depth in enumerate(cfg.depths, start=1):
        for j in range(depth):
            blk = f"block{s}.{j}"
            if s in attn:
                want.update({f"{blk}.attn.q.weight": ROW, f"{blk}.attn.q.bias": ROW,
                             f"{blk}.attn.kv.weight": KV, f"{blk}.attn.kv.bias": KV,
                             f"{blk}.attn.proj.weight": COL})
                if cfg.variant == "swin":   # the bias table's head columns
                    want[f"{blk}.attn.relative_position_bias_table"] = COL
            want.update({f"{blk}.mlp.fc1.weight": ROW, f"{blk}.mlp.fc1.bias": ROW,
                         f"{blk}.mlp.fc2.weight": COL})
            if cfg.variant == "v2":         # the depthwise conv's channels
                want.update({f"{blk}.mlp.dwconv.dwconv.weight": ROW,
                             f"{blk}.mlp.dwconv.dwconv.bias": ROW})
    # linear SR's 1x1 conv and SR-LN, and every other tensor, replicated
    assert cfg.name != "pvlt_v2_linear_tiny" or "block1.0.attn.sr.weight" in names
    if vocab:
        want.update({"text_embeddings.word_embeddings.weight": ROW, "mlm_head.bias": ROW})
    assert {n: k for n, k in split.items() if k} == want
    assert layout(_names(cfg), cfg, 1) == dict.fromkeys(split)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_merge_is_exact(tp):
    """Every tensor of the micro model (seeded) comes back exactly, each
    shard 1/tp of its split dimension, with the whole dict's names."""
    torch.manual_seed(3)
    cfg = CONFIGS["micro"]
    full = create_model(cfg, device="cpu", input_size=32).state_dict()
    shards = [shard_state_dict(full, r, tp, cfg) for r in range(tp)]
    split = layout(full, cfg, tp)
    for s in shards:
        assert list(s) == list(full)
        for n, kind in split.items():
            if kind:
                dim = 1 if kind == COL else 0
                assert s[n].shape[dim] * tp == full[n].shape[dim], n
    placed = [placed_state(s, r, tp, cfg) for r, s in enumerate(shards)]
    merged = {n: sum(p[n] for p in placed) if split[n] else placed[0][n] for n in full}
    assert list(merged) == list(full)
    for n, t in full.items():
        assert torch.equal(merged[n], t), n
    model = create_model(cfg, device="cpu", input_size=32)
    model.load_state_dict(merged, strict=True)


@pytest.mark.parametrize("tp", [2, 4])
def test_kv_rows_are_the_ranks_heads(tp):
    """pvlt_large's stage 4 K/V weight [1024, 512] (8 heads of 64): rank r's
    shard is the K rows of heads r*8/tp .. then the V rows of the same
    heads; its product split by ``split_kv`` gives those heads' K and V."""
    d, heads, hd = 512, 8, 64
    gen = torch.Generator().manual_seed(0)
    kv, bias = torch.randn(2 * d, d, generator=gen), torch.randn(2 * d, generator=gen)
    x = torch.randn(2, 5, d, generator=gen)
    k_full, v_full = split_kv(x @ kv.T + bias, heads)
    local_heads = heads // tp
    for r in range(tp):
        index = ([h * hd + i for h in range(r * local_heads, (r + 1) * local_heads)
                  for i in range(hd)]
                 + [d + h * hd + i for h in range(r * local_heads, (r + 1) * local_heads)
                    for i in range(hd)])
        w, b = shard_tensor(kv, KV, r, tp), shard_tensor(bias, KV, r, tp)
        assert torch.equal(w, kv[index]) and torch.equal(b, bias[index])
        k, v = split_kv(x @ w.T + b, local_heads)
        heads_of_r = slice(r * local_heads, (r + 1) * local_heads)
        torch.testing.assert_close(k, k_full[:, heads_of_r], rtol=0, atol=1e-4)
        torch.testing.assert_close(v, v_full[:, heads_of_r], rtol=0, atol=1e-4)
    assert not torch.equal(shard_tensor(kv, KV, 0, tp), kv[: 2 * d // tp])


def test_pvlt_large_hidden_widths():
    """pvlt_large's MLP widths (mlp ratios 8/8/4/4) all divide by 4."""
    cfg = resolve_model_config(dataclasses.replace(CONFIGS["pvlt_large"]))
    widths = [int(d * r) for d, r in zip(cfg.embed_dims, cfg.mlp_ratios)]
    assert widths == [512, 1024, 1280, 2048] and all(w % 4 == 0 for w in widths)
