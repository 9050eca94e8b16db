"""Sequence parallelism of the port (parallel/sequence.py, ``create_model(...,
sp_group=)``) on gloo ranks on the CPU.

The JAX package's contract (tests/test_sequence_parallel.py) is that
``create_model(cfg, sp_mesh=mesh)``, whose joint token stream lies over the
mesh's model axis, leaves the forward as it was. Here worker processes
(tests/_ddp_worker.py, case ``sp``) split each stage's rows over a model
group of two ranks, at world 2 (sp 2) and at world 4 (dp 2 x sp 2), for
four micro configs at 64x64 with every head on (the micro model of
tests/test_train_step.py, 16 text tokens): ``pvlt_tiny``,
``pvlt_v2_tiny`` and ``pvlt_v2_linear_tiny``, whose four stages all split
(bands of 8, 4, 2 and 1 grid rows, each a multiple of its SR ratio), and
``pvlt_tiny`` with SR ratios (8, 4, 4, 1), whose stage 3 (a 4x4 grid, bands
of 2 rows for an SR conv of 4) runs whole on both ranks. Each data rank's
eval forward is held to JAX's ``sp_mesh`` forward on a dp 2 x tp 2 mesh of
the virtual CPU devices and to JAX's unsharded forward, every logit at
rtol 2e-4 / atol 2e-5, the tolerance of that test. One fp32 step on the
global batch of 8 (v1 on its default route and on the fused_attn_train
route, v2, linear v2) is held to JAX's single-device step: the losses (the
data ranks' mean), every gradient and the BatchNorm statistics at the same
tolerance, the parameters after AdamW to the port's one-process step. With
dropout and DropPath (v1, v2, and linear v2 under --remat) the fp64 step
is held to the port's one process from the same seed within 1e-6 of each
tensor's largest magnitude, the generator left where one process leaves
it (every mask the rank's rows of the one-process mask). Both ranks of a
model group hold the same tensors. A checkpoint written under sequence
parallelism restores in one process with strict names; the VL, retrieval
and recognition evals shard over the data ranks and equal one process's.
Swin and sequence parallelism with tensor-parallel weights are refused.
The row plan, the split and gather, kernel A's band rows, kernel D's halo
band and linear SR's partial window sums are held to the whole stream's
in one process, without ranks. Two gloo spawns.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import cli, config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.eval.recognition import evaluate_recognition, make_cls_scorer
from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer
from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.ops.dwconv_mlp import dwconv_mlp_reference
from mvlt_tpu_torch.ops.sr_kv import linear_pool_shape, sr_kv_reference
from mvlt_tpu_torch.parallel import sequence
from mvlt_tpu_torch.parallel.tensor import shard_model
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from tests.test_torch_port_ddp import GLOBAL_B, PORT_TOL, assert_close_to_max, spawn
from tests.test_torch_port_ddp_eval import REC_BATCH, _vl_batch
from tests.test_torch_port_tp_families import global_batch
from tests.test_torch_port_train import LOSS_KEYS, MICRO, T, _numpy_weights, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = dict(rtol=2e-4, atol=2e-5)
IMG = 64
SP = 2
ALL_HEADS = dict(itm=True, mlm=True, t2i=True, cls=True)
OUTPUTS = ("mlm_logits", "itm_logits", "sup_cls_logits", "sub_cls_logits", "t2i_logits")
# label: (registry model, config overrides, the stages that split at sp 2)
CONFIGS = {
    "v1": ("pvlt_tiny", {}, (True, True, True, True)),
    "v2": ("pvlt_v2_tiny", {}, (True, True, True, True)),
    "linear": ("pvlt_v2_linear_tiny", {}, (True, True, True, True)),
    "mixed": ("pvlt_tiny", {"sr_ratios": (8, 4, 4, 1)}, (True, True, False, True)),
}
# fp32 steps against JAX: label: (config, overrides); JAX's step on the CPU
# takes the XLA route whatever fused_attn_train says, v1's reference
STEPS = {"v1": ("v1", {}), "v1_fused": ("v1", {"fused_attn_train": True}),
         "v2": ("v2", {}), "linear": ("linear", {})}
DROP = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1, bert_dropout=0.1)
FP64_CASES = {"dropout_v1": ("v1", DROP), "dropout_v2": ("v2", DROP),
              "remat_linear": ("linear", {**DROP, "remat": True})}


def micro(label: str) -> dict:
    name, overrides, _ = CONFIGS[label]
    return {**MICRO, "img_size": IMG, "name": name, **overrides}


def eval_data() -> dict:
    """VL batches of 8 and 3 rows, 3 retrieval bundles of 11 candidates and
    6 recognition items at 64x64."""
    rng = np.random.default_rng(17)
    # tests/test_torch_port_ddp_eval.py's batches, their 32x32 images tiled to 64x64
    vl = [{k: (np.ascontiguousarray(np.tile(v, (1, 2, 2, 1)))
               if k in ("images", "masked_images") else v)
           for k, v in _vl_batch(rng, b).items()} for b in (8, 3)]
    bundles = [{"images_101": rng.integers(0, 256, (11, IMG, IMG, 3), dtype=np.uint8),
                "ori_input_ids_101": rng.integers(0, 64, (11, T)).astype(np.int32)}
               for _ in range(3)]
    items = [{"images": rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8),
              "ori_input_ids": rng.integers(0, 64, (T,)).astype(np.int32),
              "sup_cls_labels": np.int32(rng.integers(0, 48)),
              "sub_cls_labels": np.int32(rng.integers(0, 122)),
              "info_list": f"item{i:02d}.png"} for i in range(6)]
    return {"vl_batches": vl, "bundles": bundles, "items": items, "rec_batch": REC_BATCH}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(root, {label: (JAX config, JAX model, params, stats)}, global batch,
    eval data, the workers' spec)."""
    from mvlt_tpu.models import create_model as jax_create_model

    root = tmp_path_factory.mktemp("sp")
    fams, spec_fams = {}, {}
    for i, label in enumerate(CONFIGS):
        jcfg = jax_config.ModelConfig(**micro(label), use_pallas_attention=False,
                                      loss_type=jax_config.LossType(**ALL_HEADS))
        jmodel = jax_create_model(jcfg)
        params, stats = _numpy_weights(jmodel, seed=31 + i, img=IMG)
        torch.save(state_dict_from_jax(params, stats), root / f"{label}.pt")
        fams[label] = (jcfg, jmodel, params, stats)
        spec_fams[label] = {"micro": micro(label), "weights": str(root / f"{label}.pt")}
    batch = global_batch(41)
    np.savez(root / "batch.npz", **batch)
    data = eval_data()
    torch.save(data, root / "eval.pt")
    spec = {"heads": ALL_HEADS, "img": IMG, "global_batch": GLOBAL_B, "sp": SP,
            "batch": str(root / "batch.npz"), "families": spec_fams, "cases": ["sp"]}
    return root, fams, batch, data, spec


def jax_forward(fam, batch, sp_mesh=None):
    """JAX's eval forward on the global batch, unsharded or with the joint
    stream over a dp 2 x tp 2 mesh's model axis: {output: numpy}."""
    from mvlt_tpu.models import create_model as jax_create_model
    from mvlt_tpu.parallel import shard_batch

    jcfg, jmodel, params, stats = fam
    model = jmodel if sp_mesh is None else jax_create_model(jcfg, sp_mesh=sp_mesh)
    inputs = {"images": jnp.asarray(batch["images"]), "ids": jnp.asarray(batch["input_ids"])}
    if sp_mesh is not None:
        inputs = shard_batch(sp_mesh, inputs)
    out = jax.jit(lambda v, im, i: model.apply(v, im, i, train=False))(
        {"params": params, "batch_stats": stats}, inputs["images"], inputs["ids"])
    return {k: np.asarray(out[k]) for k in OUTPUTS}


def jax_step(fam, batch):
    """(gradients, losses, BatchNorm statistics) of JAX's single-device step
    on the global batch at step 0."""
    from mvlt_tpu.train.losses import compute_losses

    jcfg, jmodel, params, stats = fam

    def loss_fn(p):
        out, new = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                                jnp.asarray(batch["input_ids"]), train=True,
                                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        losses = compute_losses(out, batch, mlm_chunk=max(jcfg.mlm_loss_chunk, 1),
                                mlm_capacity_frac=jcfg.mlm_capacity_frac, mlm_ce_kernel=False)
        return losses["total_loss"], (losses, new["batch_stats"])

    g, (losses, st) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g)),
            {k: float(v) for k, v in losses.items()}, state_dict_from_jax({}, jax.device_get(st)))


def jax_references(setup) -> dict:
    from mvlt_tpu.parallel import make_mesh

    _, fams, batch, _, _ = setup
    mesh = make_mesh(dp_size=2, tp_size=2, devices=jax.devices()[:4])
    out = {"forward": {}, "forward_sp": {}, "step": {}}
    for label, fam in fams.items():
        out["forward"][label] = jax_forward(fam, batch)
        out["forward_sp"][label] = jax_forward(fam, batch, mesh)
    for label in {c for c, _ in STEPS.values()}:
        out["step"][label] = jax_step(fams[label], batch)
    return out


@pytest.fixture(scope="module")
def runs(setup):
    """({world: every rank's ``sp`` results}, JAX's references): world 2
    (sp 2) with the fp32 steps and the fp64 dropout and remat cases, world
    4 (dp 2 x sp 2) with the fp32 steps and the evals; JAX's forwards and
    steps are taken in a thread meanwhile."""
    root, _, _, _, spec = setup
    steps = {k: [c, o, "float32"] for k, (c, o) in STEPS.items()}
    spec2 = {**spec, "ckpt_dir": str(root / "ckpt2"),
             "steps": {**steps, **{k: [c, o, "float64"] for k, (c, o) in FP64_CASES.items()}}}
    spec4 = {**spec, "ckpt_dir": str(root / "ckpt4"), "steps": steps,
             "eval_data": str(root / "eval.pt")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        refs = pool.submit(jax_references, setup)
        world2 = spawn(spec2, root / "w2", world=2)["sp"]
        world4 = spawn(spec4, root / "w4", world=4)["sp"]
        return {2: world2, 4: world4}, refs.result()


def port_config(label: str, dtype: str = "float32", **overrides) -> config.ModelConfig:
    return config.ModelConfig(**{**micro(label), "compute_dtype": dtype, **overrides},
                              loss_type=config.LossType(**ALL_HEADS))


def one_process(setup, label: str, dtype: str, **overrides):
    """The port's one-process step (seed 0) on the global batch: (model,
    state, losses)."""
    root, _, batch, _, _ = setup
    cfg = port_config(label, dtype, **overrides)
    model = create_model(cfg, device="cpu", input_size=IMG)
    model.load_state_dict(torch.load(root / f"{label}.pt", weights_only=True), strict=True)
    model.to(getattr(torch, dtype))
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), GLOBAL_B, 10, seed=0)
    state, losses = make_train_step(cfg)(state, batch)
    return model, state, {k: float(v) for k, v in losses.items()}


def data_rows(world: int, data_rank: int) -> slice:
    share = GLOBAL_B // (world // SP)
    return slice(data_rank * share, (data_rank + 1) * share)


def assert_group_equal(ranks, case):
    """Both ranks of each model group hold the same gradients, parameters
    and BatchNorm statistics after the step."""
    for g in range(0, len(ranks), SP):
        for key in ("grads", "params", "buffers"):
            for n, t in ranks[g][case][key].items():
                assert torch.equal(t, ranks[g + 1][case][key][n]), (case, key, n)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_sp_forward_matches_jax(runs, world, label):
    """Every head's logits of each data rank's rows against JAX's sp_mesh
    forward and JAX's unsharded forward; the stages split as the row plan
    says; both ranks of a model group equal."""
    ranks, refs = runs[0][world], runs[1]
    assert [(r["layout"]["data_rank"], r["layout"]["model_rank"]) for r in ranks] == [
        (i // SP, i % SP) for i in range(world)]
    for r in ranks:
        assert r["split"][label] == CONFIGS[label][2]
        rows = data_rows(world, r["layout"]["data_rank"])
        for k in OUTPUTS:
            got = r["forward"][label][k].numpy()
            np.testing.assert_allclose(got, refs["forward"][label][k][rows], err_msg=k, **TOL)
            np.testing.assert_allclose(got, refs["forward_sp"][label][k][rows], err_msg=k, **TOL)
    for g in range(0, world, SP):
        for k in OUTPUTS:
            assert torch.equal(ranks[g]["forward"][label][k], ranks[g + 1]["forward"][label][k])


def test_describe_names_the_split_stages(runs):
    lines = runs[0][2][0]["describe"]["mixed"].splitlines()
    assert lines[0] == "sequence parallelism over 2 ranks (the model replicated):"
    assert lines[1] == "  stage 1 (16x16): split, 8 of 16 grid rows and 8 of 16 text rows a rank"
    assert lines[3] == ("  stage 3 (4x4): whole on every rank (4 grid rows, 16 text rows, sr 4)")
    assert lines[4] == "  stage 4 (2x2): split, 1 of 2 grid rows and 8 of 16 text rows a rank"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(STEPS))
def test_sp_step_matches_jax_single_device(setup, runs, world, case):
    ranks, refs = runs[0][world], runs[1]
    assert_group_equal(ranks, case)
    want_g, want_l, want_bn = refs["step"][STEPS[case][0]]
    data_ranks = [r[case] for r in ranks[::SP]]     # one rank of each model group
    for k in LOSS_KEYS:
        got = float(np.mean([r["losses"][k] for r in data_ranks]))
        np.testing.assert_allclose(got, want_l[k], err_msg=k, **TOL)
    got = ranks[0][case]
    assert sorted(got["grads"]) == sorted(want_g)
    for n, w in want_g.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), w.numpy(), err_msg=n, **TOL)
    for n, w in want_bn.items():
        np.testing.assert_allclose(got["buffers"][n].numpy(), w.numpy(), err_msg=n, **TOL)
    model, _, _ = one_process(setup, STEPS[case][0], "float32", **STEPS[case][1])
    for n, p in model.named_parameters():
        np.testing.assert_allclose(got["params"][n].numpy(), p.detach().numpy(), err_msg=n,
                                   **TOL)


@pytest.mark.parametrize("case", sorted(FP64_CASES))
def test_sp_dropout_and_remat_match_one_process(setup, runs, case):
    """sp 2 in fp64 against the port's one-process step from the same
    weights and seed: losses, gradients and parameters after AdamW within
    PORT_TOL of each tensor's largest magnitude, the generator at the same
    state after the step."""
    label, overrides = FP64_CASES[case]
    ranks = runs[0][2]
    assert_group_equal(ranks, case)
    model, state, losses = one_process(setup, label, "float64", **overrides)
    got = ranks[0][case]
    assert_close_to_max(got["grads"], {n: p.grad for n, p in model.named_parameters()},
                        PORT_TOL, f"{case} grads")
    assert_close_to_max(got["params"], {n: p.detach() for n, p in model.named_parameters()},
                        PORT_TOL, f"{case} params")
    for k in LOSS_KEYS:
        assert abs(got["losses"][k] - losses[k]) <= PORT_TOL * max(abs(losses[k]), 1e-12), k
    assert torch.equal(got["generator"], state.generator.get_state())
    assert losses["loss_mlm"] > 0 and all(np.isfinite(v) for v in losses.values())


@pytest.mark.parametrize("world", [2, 4])
def test_sp_checkpoint_restores_in_one_process(setup, runs, world):
    """The v1 step's checkpoint (rank 0 of the world writes the replicated
    weights) restores strictly in one process to rank 0's parameters."""
    root = setup[0] / f"ckpt{world}"
    saved = torch.load(root / "checkpoint" / "last" / STATE_FILE, weights_only=True)
    model = create_model(port_config("v1"), device="cpu", input_size=IMG)
    assert sorted(saved["model"]) == sorted(model.state_dict())
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), GLOBAL_B, 10)
    state, epoch = CheckpointManager(str(root)).restore(state, "last")
    assert (state.step, epoch) == (1, 1)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), runs[0][world][0]["v1"]["params"][n]), n


def test_sp_evals_match_one_process(setup, runs):
    """dp 2 x sp 2: the VL eval, retrieval and recognition shard over the
    data ranks; every rank's results equal one process's (the rankings
    exactly, the VL losses within 1e-5)."""
    root, _, _, data, _ = setup
    model = create_model(port_config("v1"), device="cpu", input_size=IMG)
    model.load_state_dict(torch.load(root / "v1.pt", weights_only=True), strict=True)
    model.eval()
    cfg = model.cfg
    vl = evaluate_vl(make_vl_eval_fn(model, cfg), data["vl_batches"], is_main=False)
    retrieval = evaluate_retrieval(make_itm_scorer(model), cli._simple_loader(data["bundles"], 1),
                                   is_main=False)
    recognition = evaluate_recognition(
        make_cls_scorer(model), cli._simple_loader(data["items"], REC_BATCH),
        num_super=cfg.num_super_classes, num_sub=cfg.num_sub_classes, is_main=False)
    assert retrieval["num_queries"] == 3
    for r in runs[0][4]:
        got = r["eval"]
        assert got["retrieval"] == retrieval and got["recognition"] == recognition
        for k, v in vl.items():
            assert abs(got["vl"][k] - v) <= 1e-5 * max(abs(v), 1.0), k


def test_swin_under_sp_is_refused():
    cfg = config.ModelConfig(**{**micro("v1"), "name": "pvlt_swin_tiny"},
                             loss_type=config.LossType(**ALL_HEADS))
    with pytest.raises(NotImplementedError, match="sequence parallelism does not cover: "
                                                  "the Swin backbone"):
        create_model(cfg, device="cpu", input_size=IMG, sp_group=object())


def test_sp_with_tensor_parallel_weights_is_refused():
    model = create_model(port_config("v1"), device="cpu", input_size=IMG, sp_group=object())
    with pytest.raises(NotImplementedError, match="tensor-parallel weights"):
        shard_model(model, object())
    with pytest.raises(NotImplementedError, match="tensor-parallel weights"):
        sequence.refusals(model.cfg, object(), object())


# ---- the pieces in one process, without ranks --------------------------------------------


@pytest.mark.parametrize("h,w,t,sr,n,split,hb,tb", [
    (64, 64, 128, 8, 2, True, 32, 64),      # pvlt_tiny at 256, stage 1
    (8, 8, 128, 1, 4, True, 2, 32),         # stage 4 at sp 4
    (16, 16, 128, 8, 4, False, 16, 128),    # a band of 4 rows under an SR conv of 8
    (8, 8, 16, 8, 2, False, 8, 16),         # tests/test_sequence_parallel.py's 32x32 stage 1
    (12, 20, 15, 2, 2, False, 12, 15),      # text rows that do not divide
    (64, 64, 128, 1, 2, True, 32, 64),      # linear SR pools: no conv window
])
def test_row_plan(h, w, t, sr, n, split, hb, tb):
    plan = sequence.row_plan(h, w, t, sr, n, 1)
    assert (plan.split, plan.hb, plan.tb, plan.hw) == (split, hb, tb, (hb, w))


@pytest.mark.parametrize("n", [2, 4])
def test_split_then_gather_is_the_identity(n):
    gen = torch.Generator().manual_seed(n)
    h, w, t = 8, 6, 12
    z = torch.randn(3, h * w + t, 5, generator=gen)
    plans = [sequence.row_plan(h, w, t, 1, n, r) for r in range(n)]
    parts = torch.stack([sequence.take(z, p, p.hb * w) for p in plans])
    assert parts.shape == (n, 3, (h // n) * w + t // n, 5)
    assert torch.equal(parts[1][:, :(h // n) * w], z[:, (h // n) * w:2 * (h // n) * w])
    assert torch.equal(sequence.assemble(parts, (h // n) * w), z)
    kv = torch.randn(2, 3, 4, h * w + t, 8, generator=gen)        # K and V rows, dim -2
    parts = torch.stack([sequence.take(kv, p, p.hb * w, -2) for p in plans])
    assert torch.equal(sequence.assemble(parts, (h // n) * w, -2), kv)


def _f64(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, dtype=torch.float64) * std


@pytest.mark.parametrize("n,sr", [(2, 4), (4, 2), (2, 1)])
def test_kernel_a_band_rows_are_the_whole_grids(n, sr):
    """Kernel A's plain version on a band gives that band's reduced rows
    and text rows of the whole grid's K/V (its conv windows never cross a
    band), so gathering them is the whole K/V."""
    gen = torch.Generator().manual_seed(7 * n + sr)
    h, w, t, d, heads = 16, 12, 8, 32, 2
    x = _f64(gen, 2, h * w + t, d)
    args = (_f64(gen, d, std=0.1) + 1, _f64(gen, d, std=0.1),
            _f64(gen, d, d, sr, sr, std=0.1) if sr > 1 else None,
            _f64(gen, d, std=0.1) if sr > 1 else None,
            _f64(gen, d, std=0.1) + 1 if sr > 1 else None,
            _f64(gen, d, std=0.1) if sr > 1 else None,
            _f64(gen, 2 * d, d, std=0.2), _f64(gen, 2 * d, std=0.1))
    kw = dict(sr=sr, heads=heads, eps1=1e-6, eps_sr=1e-5)
    k, v = sr_kv_reference(x, (h, w), *args, **kw)
    parts = []
    for r in range(n):
        plan = sequence.row_plan(h, w, t, sr, n, r)
        assert plan.split
        kb, vb = sr_kv_reference(sequence.take(x, plan, plan.hb * w), plan.hw, *args, **kw)
        m_vis = sequence.kv_visual_rows(plan, sr)
        torch.testing.assert_close(kb, sequence.take(k, plan, m_vis, -2), rtol=1e-12, atol=1e-12)
        parts.append(torch.stack([kb, vb]))
    torch.testing.assert_close(sequence.assemble(torch.stack(parts), m_vis, -2),
                               torch.stack([k, v]), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_kernel_d_halo_band_is_the_whole_grids(n):
    """Kernel D's plain version on a band with one halo grid row from each
    neighbour (none at the grid's edges), its halo rows dropped, gives the
    band's rows of the whole grid's output; without the halo the band's
    edge rows differ."""
    gen = torch.Generator().manual_seed(n)
    h, w, t, d, hid = 8, 6, 4, 16, 32
    x = _f64(gen, 2, h * w + t, d)
    args = (_f64(gen, d, std=0.1) + 1, _f64(gen, d, std=0.1), _f64(gen, hid, d, std=0.3),
            _f64(gen, hid, std=0.1), _f64(gen, hid, 1, 3, 3, std=0.5), _f64(gen, hid, std=0.1),
            _f64(gen, d, hid, std=0.2), _f64(gen, d, std=0.1))
    whole = dwconv_mlp_reference(x, (h, w), *args, eps=1e-6)
    for r in range(n):
        plan = sequence.row_plan(h, w, t, 1, n, r)
        ext = sequence.halo_band(x, plan)
        assert ext.shape[1] == plan.halo_hw[0] * w + plan.tb
        got = sequence.trim_halo(dwconv_mlp_reference(ext, plan.halo_hw, *args, eps=1e-6), plan)
        want = sequence.take(whole, plan, plan.hb * w)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        bare = dwconv_mlp_reference(sequence.take(x, plan, plan.hb * w), plan.hw, *args, eps=1e-6)
        assert (bare - want).abs().max() > 1e-3


@pytest.mark.parametrize("h,n", [(64, 2), (64, 4), (32, 4), (16, 2)])
def test_linear_sr_partial_windows_sum_to_the_whole_pool(h, n):
    """Linear SR's floored windows (9 rows at 64, the 64th row dropped;
    4 at 32, 2 at 16, two rows dropped) straddle the bands at 64: the
    ranks' partial window sums, added and divided by the window's count,
    are the average pool of the whole grid."""
    gen = torch.Generator().manual_seed(h + n)
    w, d = h, 8
    grid = _f64(gen, 2, h, w, d)
    win, out = linear_pool_shape((h, w))
    want = F.avg_pool2d(grid.permute(0, 3, 1, 2), win, win).permute(0, 2, 3, 1)
    assert want.shape[1:3] == out
    total = 0
    for r in range(n):
        plan = sequence.row_plan(h, w, 16, 1, n, r)
        total = total + sequence.linear_pool_partial(grid[:, r * plan.hb:(r + 1) * plan.hb],
                                                     plan, win, out)
    torch.testing.assert_close(total / (win[0] * win[1]), want, rtol=1e-12, atol=1e-12)
    if h == 64:     # a window crosses the first band's end
        assert (h // n) % win[0]
