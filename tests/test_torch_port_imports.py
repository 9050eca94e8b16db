"""The port runs where JAX and the JAX package are absent: a GPU host for it
needs no jax, no flax, no PIL, no cv2 and nothing of mvlt_tpu."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "mvlt_tpu_torch"
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}   # as one_torch_thread, in the child

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
from mvlt_tpu_torch.ops import block_attention
for with_stats in (False, True):
    fused = ModelConfig(**micro, fused_attn_train=True, fused_attn_stats=with_stats)
    state = create_train_state(create_model(fused, device="cpu"), OptimConfig(warmup_epochs=0),
                               2, 1)
    calls = []
    ref = block_attention.block_attention_bwd_reference
    block_attention.block_attention_bwd_reference = lambda *a, **k: calls.append(1) or ref(*a, **k)
    state, stats = train_one_epoch(make_train_step(fused), state, batches(data, 2),
                                   is_main=False)
    block_attention.block_attention_bwd_reference = ref
    assert len(calls) == 8 and np.isfinite(stats["total_loss"]), (calls, stats)
for name, extra in (("pvlt_v2_tiny", {}), ("pvlt_v2_linear_tiny", dict(remat=True)),
                    ("pvlt_swin_tiny", dict(drop_rate=0.1))):
    train_cfg = ModelConfig(**micro, name=name, **extra)
    state = create_train_state(create_model(train_cfg, device="cpu", input_size=32),
                               OptimConfig(warmup_epochs=0), 2, 1)
    state, stats = train_one_epoch(make_train_step(train_cfg), state, batches(data, 2),
                                   is_main=False)
    assert state.step == 1 and np.isfinite(stats["total_loss"]), (name, stats)
import os, tempfile
from mvlt_tpu_torch import cli
with tempfile.TemporaryDirectory() as out:
    cli.main(["--config", "configs/test_micro.py", "--synthetic-data", "--device", "cpu",
              "--batch-size", "48", "--epochs", "1", "--output-dir", out])
    assert os.path.exists(os.path.join(out, "checkpoint", "last", "state.pt"))
del sys.modules["PIL"]      # the train reader decodes with Pillow; jax stays blocked
import pickle
from PIL import Image
from mvlt_tpu_torch.data import native
from mvlt_tpu_torch.data.fashion_gen import FashionGenPretrain
from mvlt_tpu_torch.data.tokenizer import WordPieceTokenizer
with tempfile.TemporaryDirectory() as root:
    for sub in ("extracted_train_images", "full_train_info_PAI"):
        os.makedirs(os.path.join(root, sub))
    img = np.full((40, 30, 3), 255, np.uint8)
    img[5:30, 4:20] = 60
    Image.fromarray(img).save(os.path.join(root, "extracted_train_images", "p0.png"))
    with open(os.path.join(root, "full_train_info_PAI", "p0.pkl"), "wb") as f:
        pickle.dump({"img_name": "p0.png", "super_cls_id": 1, "sub_cls_id": 2,
                     "captions": "a wool coat"}, f)
    reader = FashionGenPretrain(root, "train", DataConfig(input_size=32, num_text_tokens=16),
                                itm_enabled=False)
    assert isinstance(reader.tokenizer, native.NativeTokenizer)
    item = reader[0]
    assert np.array_equal(item["images"], native.native_crop_resize(img, 32)), "not native"
    plain = WordPieceTokenizer(DataConfig().vocab_file).encode("a wool coat", 16)
    assert item["ori_input_ids"].tolist() == plain, item
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "mvlt_tpu"))
assert not [m for m in loaded if sys.modules[m] is not None], loaded
print("OK")
"""


def test_port_imports_and_serves_without_jax():
    """Serving (v1, v2 and Swin), one training step on the default route and
    one on the fused_attn_train route in each backward form, and one epoch
    through the CLI (training, VL eval, checkpoint) of the port with jax,
    flax and the JAX package blocked; then, with Pillow allowed, an item of
    the train reader through the native crop-resize and tokenizer."""
    proc = subprocess.run([sys.executable, "-c", _GUARDED], cwd=REPO, env=ONE_THREAD,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


_EVAL_GUARDED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "PIL", "cv2", "mvlt_tpu"):
    sys.modules[name] = None
import os, pickle, tempfile
from mvlt_tpu_torch import cli
with tempfile.TemporaryDirectory() as root:
    for sub in ("extracted_valid_images", "full_valid_info_PAI", "retrieve_ITR"):
        os.makedirs(os.path.join(root, sub))
    open(os.path.join(root, "extracted_valid_images", "p0.png"), "wb").close()
    with open(os.path.join(root, "full_valid_info_PAI", "p0.pkl"), "wb") as f:
        pickle.dump({"img_name": "p0.png", "super_cls_id": 1, "sub_cls_id": 2,
                     "captions": "a wool coat"}, f)
    with open(os.path.join(root, "retrieve_ITR", "q0.pkl"), "wb") as f:
        pickle.dump({0: {"img_name": "p0.png", "captions": "a wool coat"}}, f)
    for flag in ("--eval-recognition", "--eval-retrieval-itr"):
        try:
            cli.main(["--config", "configs/test_micro.py", "--device", "cpu",
                      "--data-path", root, "--output-dir", root, flag])
        except ImportError as e:      # the first image read needs Pillow
            assert "PIL" in str(e), e
            print("read", flag)
        else:
            raise AssertionError(f"{flag} ran without reading an image")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "mvlt_tpu", "PIL", "cv2"))
assert not [m for m in loaded if sys.modules[m] is not None], loaded
print("OK")
"""


def test_eval_branches_import_without_pil_and_cv2():
    """The recognition and retrieval evals of the CLI run with PIL, cv2, jax,
    flax and the JAX package blocked up to their first image read, which
    needs Pillow: the readers, metrics and scorers import none of them."""
    proc = subprocess.run([sys.executable, "-c", _EVAL_GUARDED], cwd=REPO, env=ONE_THREAD,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("read --eval") == 2 and proc.stdout.strip().endswith("OK")


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


def test_two_rank_step_without_jax(tmp_path):
    """Two gloo ranks (tests/_ddp_worker.py) each take a DDP step, with
    grad_accum 1 and 2, with jax, flax and the JAX package blocked in both:
    finite losses, the same reduced gradients on both ranks."""
    import numpy as np
    import torch

    from mvlt_tpu_torch import config
    from mvlt_tpu_torch.models.pvlt import create_model
    from tests.test_torch_port_ddp import GLOBAL_B, HEADS, make_global_batch, spawn
    from tests.test_torch_port_train import IMG, MICRO

    torch.manual_seed(0)
    model = create_model(config.ModelConfig(**MICRO, loss_type=config.LossType(**HEADS)),
                         device="cpu", input_size=IMG)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **make_global_batch())
    spec = {"micro": MICRO, "heads": HEADS, "img": IMG, "global_batch": GLOBAL_B,
            "weights": str(tmp_path / "weights.pt"), "batch": str(tmp_path / "batch.npz"),
            "step_dtypes": ["float32"], "cases": ["step"]}
    runs = spawn(spec, tmp_path / "out", guard=True)["step"]
    for key in ("float32_accum1", "float32_accum2"):
        a, b = runs[0][key], runs[1][key]
        assert all(np.isfinite(v) for v in a["losses"].values()), a["losses"]
        assert sorted(a["grads"]) == sorted(b["grads"])
        assert all(torch.equal(g, b["grads"][n]) for n, g in a["grads"].items())


def test_sequence_parallel_forward_and_step_without_jax(tmp_path):
    """Two gloo ranks of one model group (tests/_ddp_worker.py, case sp)
    run the sequence-parallel eval forward and step of pvlt_tiny and
    pvlt_v2_tiny at 64x64 with jax, flax and the JAX package blocked in
    both: every stage split, finite losses, the same logits and gradients
    on both ranks."""
    import numpy as np
    import torch

    from mvlt_tpu_torch import config
    from mvlt_tpu_torch.models.pvlt import create_model
    from tests.test_torch_port_ddp import GLOBAL_B, HEADS, spawn
    from tests.test_torch_port_tp_families import global_batch
    from tests.test_torch_port_train import MICRO

    families = {}
    for label, name in (("v1", "pvlt_tiny"), ("v2", "pvlt_v2_tiny")):
        micro = {**MICRO, "img_size": 64, "name": name}
        torch.manual_seed(0)
        model = create_model(config.ModelConfig(**micro, loss_type=config.LossType(**HEADS)),
                             device="cpu", input_size=64)
        torch.save(model.state_dict(), tmp_path / f"{label}.pt")
        families[label] = {"micro": micro, "weights": str(tmp_path / f"{label}.pt")}
    np.savez(tmp_path / "batch.npz", **global_batch(5))
    spec = {"heads": HEADS, "img": 64, "global_batch": GLOBAL_B, "sp": 2,
            "batch": str(tmp_path / "batch.npz"), "families": families,
            "steps": {"v1": ["v1", {}, "float32"], "v2": ["v2", {}, "float32"]},
            "ckpt_dir": str(tmp_path / "ckpt"), "cases": ["sp"]}
    a, b = spawn(spec, tmp_path / "out", guard=True)["sp"]
    for label in families:
        assert a["split"][label] == (True, True, True, True)
        assert all(torch.equal(t, b["forward"][label][k]) for k, t in a["forward"][label].items())
        assert all(np.isfinite(v) for v in a[label]["losses"].values()), a[label]["losses"]
        assert all(torch.equal(g, b[label]["grads"][n]) for n, g in a[label]["grads"].items())


def test_planted_faults_find_their_lines():
    """Every fault of chip_faults.py finds the line it rewrites exactly once
    in its source, so none goes stale unnoticed until a card run."""
    import chip_faults

    for name, (phase, source, good, bad) in chip_faults.FAULTS.items():
        assert (REPO / source).read_text().count(good) == 1, name
        assert good != bad and phase in chip_faults.MARGINS, name
