"""The port runs where JAX and the JAX package are absent: a GPU host for it
needs no jax, no flax, no PIL, no cv2 and nothing of mvlt_tpu."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "mvlt_tpu_torch"

_GUARDED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "PIL", "cv2", "mvlt_tpu"):
    sys.modules[name] = None        # any import of them now fails
import importlib, pkgutil
import mvlt_tpu_torch
for info in pkgutil.walk_packages(mvlt_tpu_torch.__path__, "mvlt_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
import numpy as np
import torch
from mvlt_tpu_torch.config import DataConfig, LossType, ModelConfig, OptimConfig
from mvlt_tpu_torch.data.fashion_gen import SyntheticFashionGen, batches
from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.train.engine import train_one_epoch
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
micro = dict(img_size=32, embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 2, 4),
             mlp_ratios=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1), token_hidden_size=32,
             num_text_tokens=16, max_position_embeddings=32, itg_channel=8,
             compute_dtype="float32", mlm_ce_kernel=False)
cfg = ModelConfig(**micro, loss_type=LossType(itm=True, mlm=False, t2i=False, cls=False))
model = create_model(cfg, device="cpu").eval()
bundle = {"images_101": np.zeros((5, 32, 32, 3), np.uint8),
          "ori_input_ids_101": np.zeros((5, 16), np.int32)}
res = evaluate_retrieval(make_itm_scorer(model), [bundle], is_main=False)
assert res["num_queries"] == 1, res
v2 = create_model(ModelConfig(**micro, name="pvlt_v2_tiny", loss_type=cfg.loss_type),
                  device="cpu").eval()
assert v2.cfg.variant == "v2"
res = evaluate_retrieval(make_itm_scorer(v2), [bundle], is_main=False)
assert res["num_queries"] == 1, res
swin = create_model(ModelConfig(**micro, name="pvlt_swin_tiny", loss_type=cfg.loss_type),
                    device="cpu", input_size=32).eval()
assert swin.cfg.variant == "swin"
res = evaluate_retrieval(make_itm_scorer(swin), [bundle], is_main=False)
assert res["num_queries"] == 1, res
cfg = ModelConfig(**micro)
model = create_model(cfg, device="cpu")
state = create_train_state(model, OptimConfig(warmup_epochs=0), 2, 1)
data = SyntheticFashionGen(DataConfig(input_size=32, num_text_tokens=16), size=2)
state, stats = train_one_epoch(make_train_step(cfg), state, batches(data, 2), is_main=False)
assert state.step == 1 and np.isfinite(stats["total_loss"]), stats
import os, tempfile
from mvlt_tpu_torch import cli
with tempfile.TemporaryDirectory() as out:
    cli.main(["--config", "configs/test_micro.py", "--synthetic-data", "--device", "cpu",
              "--batch-size", "48", "--epochs", "1", "--output-dir", out])
    assert os.path.exists(os.path.join(out, "checkpoint", "last", "state.pt"))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "mvlt_tpu"))
assert not [m for m in loaded if sys.modules[m] is not None], loaded
print("OK")
"""


def test_port_imports_and_serves_without_jax():
    """Serving (v1, v2 and Swin), one training step and one epoch through the CLI
    (training, VL eval, checkpoint) of the port with jax, flax and the JAX
    package blocked."""
    proc = subprocess.run([sys.executable, "-c", _GUARDED], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import\s+(jax|flax|mvlt_tpu)\b(?!_)|from\s+(jax|flax|mvlt_tpu)\b(?!_))", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_faults.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
    assert pattern.search("from mvlt_tpu.config import ModelConfig")
    assert pattern.search("import mvlt_tpu")
    assert not pattern.search("from mvlt_tpu_torch.config import ModelConfig")
