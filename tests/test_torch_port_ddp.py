"""The port's data-parallel step on two gloo ranks on the CPU.

The JAX package's contract (tests/test_train_step.py:98,
test_dp_matches_single_device) is that the data-parallel step equals the
single-device step on the global batch. Here two worker processes
(tests/_ddp_worker.py) each hold half of a global batch of 8 of the micro
model with ITM + MLM + T2I (DropPath and dropout off, fp32) and the same
seeded weights, bridged from the JAX side; rank 0's rows carry about eight
times the MLM labels of rank 1's, so a per-rank MLM mean or per-rank
BatchNorm statistics would show. The DDP step's gradients, losses (the
ranks' mean) and BatchNorm statistics are held to JAX's single-device step
at rtol 2e-4 / atol 2e-5, and to the port's one-process step at 1e-6 of
each tensor's largest magnitude, with grad_accum 1 and 2 (each rank holding
its share of each global microbatch, as a data mesh shards them). The
comparisons with the port's own step run in fp64, masters included: in fp32
a gradient summed over the batch with cancellation, such as stage 4's
pos-embed at a 1 x 1 grid, differs by up to 5e-5 of its largest magnitude
between the two summation orders (each rank's fp32 partial sum rounded
before DDP adds them), which would hide the 1e-6 bound. ZeRO-1 (in fp64 too) takes the
same step with the AdamW moments split between the ranks, and its
checkpoint resumes in one process without ZeRO-1 and takes the same next
step. The global MLM gather plan keeps exactly the one-process plan's
rows, also where the labels overflow the capacity; the meters'
synchronized averages are every rank's values together, on both ranks.
Two spawns of two processes each.
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import create_model
from mvlt_tpu_torch.train.losses import mlm_gather_plan
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from tests.test_torch_port_train import IMG, LOSS_KEYS, MICRO, T, _numpy_weights, one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_ddp_worker.py"
GLOBAL_B = 8
HEADS = dict(itm=True, mlm=True, t2i=True, cls=False)
PLAN_FRAC = 0.16
PORT_TOL = 1e-6


SPAWN_TIMEOUT_S = 300.0     # one deadline for all the ranks of a spawn or launch


def _stop(procs) -> None:
    """Kill every process still running, with its process group (a launcher's
    workers too), and reap it."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        p.wait()


def _wait_all(procs, deadline: float) -> str:
    """Wait until every process has exited 0 (""), one has exited otherwise
    or the deadline passed (what happened); the others are then killed at
    once."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                return f"process {bad[0][0]} exited {bad[0][1]}"
            if all(c == 0 for c in codes):
                return ""
            if time.monotonic() > deadline:
                return f"still running after the deadline: {[i for i, c in enumerate(codes) if c is None]}"
            time.sleep(0.1)
    finally:
        _stop(procs)


def _popen(cmd, log: pathlib.Path, env: dict) -> subprocess.Popen:
    """``cmd`` in its own session (so that its process group can be killed),
    stdout and stderr into ``log`` (a file: no pipe can fill, and no
    orphaned child can hold one open)."""
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)


def spawn(spec: dict, out: pathlib.Path, world: int = 2, guard: bool = False,
          timeout: float = SPAWN_TIMEOUT_S, nodes: int = 1) -> dict:
    """Run the spec's cases on ``world`` gloo ranks; {case: [rank 0's, ...]}.
    ``nodes``: the ranks set the torchrun environment of that many nodes
    (LOCAL_WORLD_SIZE world / nodes, a node's ranks consecutive, GROUP_RANK
    the node), all on this machine.
    This process holds the rendezvous store on a port it bound (port 0) and
    keeps it until the ranks are done, and the ranks join it as clients
    (torchrun's agent store), so no port is picked and released before
    use. One deadline covers all the ranks; when one exits non-zero or the
    deadline passes, every rank is killed at once. The ranks' process group
    times out at a third of the deadline."""
    out.mkdir(parents=True, exist_ok=True)
    spec = {**spec, "world": world, "out": str(out), "pg_timeout_s": timeout / 3}
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    store = torch.distributed.TCPStore("127.0.0.1", 0, world, is_master=True,
                                       wait_for_workers=False)
    procs = []
    try:
        local = world // nodes
        for r in range(world):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(r % local), "LOCAL_WORLD_SIZE": str(local),
                   "GROUP_RANK": str(r // local), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(store.port), "TORCHELASTIC_USE_AGENT_STORE": "True",
                   "OMP_NUM_THREADS": "1"}
            procs.append(_popen([sys.executable, str(WORKER), str(path)]
                                + (["--guard"] if guard else []), out / f"rank{r}.log", env))
        failure = _wait_all(procs, time.monotonic() + timeout)
    finally:
        _stop(procs)
        del store
    logs = "".join(f"--- rank {r}\n" + (out / f"rank{r}.log").read_text()[-4000:]
                   for r in range(world))
    assert not failure, f"{failure}\n{logs}"
    return {case: [torch.load(out / f"{case}_{r}.pt", weights_only=False) for r in range(world)]
            for case in spec["cases"]}


def torchrun(nproc: int, args: list, log: pathlib.Path, timeout: float = SPAWN_TIMEOUT_S) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node=nproc
    <args>`` (its rendezvous store bound on port 0 and kept by the agent;
    every process killed at the deadline); asserts it exits 0 and returns
    its output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}"] + args
    proc = _popen(cmd, log, {**os.environ, "OMP_NUM_THREADS": "1"})
    failure = _wait_all([proc], time.monotonic() + timeout)
    text = log.read_text()
    assert not failure, f"{failure}\n{text[-8000:]}"
    return text


def make_global_batch(seed: int = 3) -> dict:
    """Rows 0-3 (rank 0's) labeled at 40%, rows 4-7 at 5%."""
    rng = np.random.default_rng(seed)
    b = GLOBAL_B
    imgs = rng.random((b, IMG, IMG, 3)).astype(np.float32)
    rate = np.where(np.arange(b) < b // 2, 0.4, 0.05)[:, None]
    labels = np.where(rng.random((b, T)) < rate, rng.integers(0, 64, (b, T)), -1)
    labels[b // 2, 0] = 7                       # rank 1 holds at least one label
    return {
        "images": imgs,
        "masked_images": np.where(rng.random((b, IMG, IMG, 1)) < 0.5, 1e-6,
                                  imgs).astype(np.float32),
        "input_ids": rng.integers(0, 64, (b, T)).astype(np.int32),
        "mlm_labels": labels.astype(np.int32),
        "itm_labels": rng.integers(0, 2, (b,)).astype(np.int32),
        "sup_cls_labels": rng.integers(0, 48, (b,)).astype(np.int32),
        "sub_cls_labels": rng.integers(0, 122, (b,)).astype(np.int32),
    }


def plan_labels() -> dict:
    """[80, 16] label sets split 40 rows a rank (capacity 512 of 1,280 rows):
    under the capacity; over it in rank 1's rows; filled by rank 0 alone."""
    rng = np.random.default_rng(9)
    sets = {}
    for name, (r0, r1) in {"under": (0.15, 0.15), "overflow": (0.5, 0.4),
                           "rank0_fills": (0.94, 0.3)}.items():
        rate = np.where(np.arange(80) < 40, r0, r1)[:, None]
        sets[name] = np.where(rng.random((80, T)) < rate, rng.integers(0, 64, (80, T)),
                              -1).astype(np.int32)
    return sets


def _configs():
    return (jax_config.ModelConfig(**MICRO, use_pallas_attention=False,
                                   loss_type=jax_config.LossType(**HEADS)),
            config.ModelConfig(**MICRO, loss_type=config.LossType(**HEADS)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX config, JAX model, params, stats, port config, global batch,
    the workers' spec) with the weights, batch and label sets on disk."""
    from mvlt_tpu.models import create_model as jax_create_model

    jcfg, pcfg = _configs()
    jmodel = jax_create_model(jcfg)
    params, stats = _numpy_weights(jmodel, seed=1)
    root = tmp_path_factory.mktemp("ddp")
    torch.save(state_dict_from_jax(params, stats), root / "weights.pt")
    batch = make_global_batch()
    np.savez(root / "batch.npz", **batch)
    np.savez(root / "plan.npz", **plan_labels())
    spec = {"micro": MICRO, "heads": HEADS, "img": IMG, "global_batch": GLOBAL_B,
            "weights": str(root / "weights.pt"), "batch": str(root / "batch.npz"),
            "plan_labels": str(root / "plan.npz"), "plan_frac": PLAN_FRAC,
            "ckpt_dir": str(root / "zero1_run"), "step_dtypes": ["float32", "float64"],
            "zero_dtype": "float64"}
    return jcfg, jmodel, params, stats, pcfg, batch, spec, root


@pytest.fixture(scope="module")
def step_runs(setup):
    return spawn({**setup[6], "cases": ["step", "plan", "meters"]}, setup[7] / "step")


@pytest.fixture(scope="module")
def zero_runs(setup):
    return spawn({**setup[6], "cases": ["zero"]}, setup[7] / "zero")["zero"]


def jax_step(setup, grad_accum: int):
    """JAX's single-device step on the global batch: (gradients as a port
    state dict, losses, new BatchNorm statistics as a state dict); with
    grad_accum k the mean of k microbatches' gradients, the statistics
    threaded through them, the losses' mean (mvlt_tpu/train/step.py)."""
    from mvlt_tpu.train.losses import compute_losses

    jcfg, jmodel, params, stats, _, batch, _, _ = setup

    def loss_fn(p, st, b):
        out, new = jmodel.apply({"params": p, "batch_stats": st}, jnp.asarray(b["images"]),
                                jnp.asarray(b["input_ids"]), train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        losses = compute_losses(out, b, mlm_chunk=max(jcfg.mlm_loss_chunk, 1),
                                mlm_capacity_frac=jcfg.mlm_capacity_frac, mlm_ce_kernel=False)
        return losses["total_loss"], (losses, new["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    mb = GLOBAL_B // grad_accum
    grads, parts, st = None, [], stats
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        g, (losses, st) = grad_fn(params, st, micro)
        g = jax.tree_util.tree_map(lambda x: np.asarray(x) / grad_accum, g)
        grads = g if grads is None else jax.tree_util.tree_map(np.add, grads, g)
        parts.append({k: float(v) for k, v in losses.items()})
    losses = {k: float(np.mean([p[k] for p in parts])) for k in parts[0]}
    return state_dict_from_jax(grads), losses, state_dict_from_jax({}, jax.device_get(st))


def port_state(setup, step: int = 0, dtype: str = "float32"):
    pcfg, root = dataclasses.replace(setup[4], compute_dtype=dtype), setup[7]
    model = create_model(pcfg, device="cpu", input_size=IMG)
    model.load_state_dict(torch.load(root / "weights.pt", weights_only=True), strict=True)
    model.to(getattr(torch, dtype))
    state = create_train_state(model, config.OptimConfig(warmup_epochs=0), GLOBAL_B, 10)
    state.step = step
    return state


def snapshot(state, losses) -> dict:
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
            "buffers": {n: b.detach().clone() for n, b in state.model.named_buffers()}}


def port_step(setup, grad_accum: int, dtype: str) -> dict:
    state = port_state(setup, dtype=dtype)
    state, losses = make_train_step(state.model.cfg, grad_accum=grad_accum)(state, setup[5])
    return snapshot(state, losses)


def rank_mean(runs, key) -> dict:
    return {k: float(np.mean([r[key][k] for r in runs])) for k in runs[0][key]}


def assert_close_to_max(got: dict, want: dict, tol: float, what: str) -> None:
    """Every tensor of ``want`` matched within ``tol`` of its largest magnitude."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        err = float((got[name].double() - w.double()).abs().max())
        assert err <= tol * float(w.abs().max()) + 1e-12, (what, name, err)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_ranks_match_jax_single_device(setup, step_runs, grad_accum, one_torch_thread):
    runs = [r[f"float32_accum{grad_accum}"] for r in step_runs["step"]]
    for name, g in runs[0]["grads"].items():    # DDP leaves every rank the same mean
        assert torch.equal(g, runs[1]["grads"][name]), name
    want_g, want_l, want_bn = jax_step(setup, grad_accum)
    got_l = rank_mean(runs, "losses")
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got_l[k], want_l[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert sorted(runs[0]["grads"]) == sorted(want_g)
    for name, w in want_g.items():
        np.testing.assert_allclose(runs[0]["grads"][name].numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    for name, w in want_bn.items():
        for r in runs:
            np.testing.assert_allclose(r["buffers"][name].numpy(), w.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=name)

    runs = [r[f"float64_accum{grad_accum}"] for r in step_runs["step"]]
    got_l = rank_mean(runs, "losses")
    one = port_step(setup, grad_accum, "float64")
    assert_close_to_max(runs[0]["grads"], one["grads"], PORT_TOL, "grads")
    assert_close_to_max({k: r for k, r in runs[1]["buffers"].items()}, one["buffers"], PORT_TOL,
                        "BatchNorm statistics")
    for k in LOSS_KEYS:
        assert abs(got_l[k] - one["losses"][k]) <= PORT_TOL * max(abs(one["losses"][k]), 1e-12), k
    if grad_accum == 1:   # the imbalance the test is built on
        labels = setup[5]["mlm_labels"]
        assert (labels[:4] >= 0).sum() > 4 * (labels[4:] >= 0).sum() > 0
        assert abs(runs[0]["losses"]["loss_mlm"] - runs[1]["losses"]["loss_mlm"]) > 0.5


@pytest.mark.parametrize("name", ["under", "overflow", "rank0_fills"])
def test_global_gather_plan(setup, step_runs, name):
    """Per-rank plans with the counts exchanged keep the rows of the
    one-process plan on the concatenated labels, in order; a plan on each
    rank's labels alone keeps others where the labels overflow. Every rank
    has the global count kept, the MLM mean's divisor."""
    labels = torch.from_numpy(plan_labels()[name])
    idx, sel, _, total = mlm_gather_plan(labels, capacity_frac=PLAN_FRAC)
    want = idx[sel != -1]
    ranks = [r[name] for r in step_runs["plan"]]
    got = torch.cat([r["kept"] for r in ranks])
    assert torch.equal(got, want)
    assert int(total) == want.numel() and all(r["total"] == want.numel() for r in ranks)
    assert all(r["slots"] == min(labels.numel() // 2, 512) for r in ranks)
    n_labeled = int((labels >= 0).sum())
    assert (n_labeled > 512) == (name != "under") and want.numel() == min(n_labeled, 512)
    alone = [mlm_gather_plan(labels[r * 40:(r + 1) * 40], capacity_frac=PLAN_FRAC)
             for r in range(2)]
    alone = torch.cat([i[s != -1] + r * 640 for r, (i, s, _, _) in enumerate(alone)])
    assert torch.equal(alone, want) == (name == "under")


def test_meters_synchronize(step_runs):
    runs = [r for r in step_runs["meters"]]
    values = [10.0 * r + v for r in range(2) for v in range(3 + 2 * r)]
    for r in runs:
        assert r["counts"] == {"loss": len(values), "lr": len(values)}
        assert r["global"]["loss"] == pytest.approx(np.mean(values), rel=1e-12)
        assert r["global"]["lr"] == 0.5
    assert runs[0]["global"] == runs[1]["global"]


def test_zero1_matches_the_plain_ddp_step(setup, zero_runs):
    """The same gradients and, after AdamW, parameters within 1e-6; each
    rank holds half of every moment that splits by element
    (parallel/sharding.py:zero1_dim) and the whole of the others, exactly;
    every block's cast cache follows the step (it was filled before it)."""
    from mvlt_tpu_torch.parallel.sharding import zero1_dim

    params = list(port_state(setup, dtype=setup[6]["zero_dtype"]).model.parameters())
    full = 2 * sum(p.numel() * p.element_size() for p in params)
    whole = 2 * sum(p.numel() * p.element_size() for p in params if zero1_dim(p, 2) is None)
    shares = [r["zero1"]["moment_bytes"] for r in zero_runs]
    assert [r["plain"]["moment_bytes"] for r in zero_runs] == [full, full]
    assert (full - whole) % 2 == 0 and full - whole > 0.9 * full
    assert shares == [(full - whole) // 2 + whole] * 2, shares
    for r in zero_runs:
        for name, p in r["plain"]["params"].items():
            assert torch.equal(r["zero1"]["grads"][name], r["plain"]["grads"][name]), name
            assert float((r["zero1"]["params"][name] - p).abs().max()) <= 1e-6, name
        for tag in ("plain", "zero1"):
            assert r[tag]["cache_fresh"] and r[tag]["cache_moved"], tag
    for name, p in zero_runs[0]["zero1"]["params"].items():
        assert torch.equal(p, zero_runs[1]["zero1"]["params"][name]), name


def test_zero1_checkpoint_resumes_in_one_process(setup, zero_runs, one_torch_thread):
    """Rank 0 wrote the unwrapped names, both ranks' generators and the
    consolidated AdamW state; one process without ZeRO-1 restores it and
    takes the step the two ZeRO-1 ranks took next."""
    saved = torch.load(os.path.join(setup[6]["ckpt_dir"], "checkpoint", "last", STATE_FILE),
                       weights_only=True)
    state = port_state(setup, dtype=setup[6]["zero_dtype"])
    assert sorted(saved["model"]) == sorted(state.model.state_dict())
    assert len(saved["generators"]) == 2 and saved["step"] == 1
    assert len(saved["optimizer"]["state"]) == len(list(state.model.parameters()))
    state, epoch = CheckpointManager(setup[6]["ckpt_dir"]).restore(state, "last")
    assert (state.step, epoch) == (1, 1)
    state, losses = make_train_step(state.model.cfg)(state, setup[5])
    one = snapshot(state, losses)
    runs = [r["zero1_next"] for r in zero_runs]
    assert_close_to_max(runs[0]["grads"], one["grads"], PORT_TOL, "grads")
    got_l = rank_mean(runs, "losses")
    for k in LOSS_KEYS:
        assert abs(got_l[k] - one["losses"][k]) <= PORT_TOL * max(abs(one["losses"][k]), 1e-12), k
    for name, p in one["params"].items():
        np.testing.assert_allclose(runs[0]["params"][name].numpy(), p.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
