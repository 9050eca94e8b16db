"""The plain reference against the port's CPU path at a micro configuration
in float32: the served ITM logits, and three training steps (losses, the
first gradient as AdamW got it, the change of the parameters), the masks of
dropout and DropPath worked out again from the generator's seed. (A test
may import the port; the reference itself does not.)"""

import numpy as np
import pytest
import torch

from port_bench import weights
from port_bench.reference import pvlt as ref
from port_bench.tests import micro


def port_model(variant_name: str, **loss_type):
    from mvlt_tpu_torch.config import LossType, ModelConfig
    from mvlt_tpu_torch.models.pvlt import create_model

    cfg = micro.config(variant_name)
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}
    mcfg = ModelConfig(**fields, loss_type=LossType(**loss_type))
    model = create_model(mcfg, device="cpu", input_size=cfg["input_size"])
    sd = weights.make_weights({k: tuple(v.shape) for k, v in model.state_dict().items()}, 123,
                              "cpu")
    model.load_state_dict(sd)
    return mcfg, model, sd, ref.Arch.from_dict(cfg["model"])


@pytest.mark.parametrize("name", ["pvlt_tiny", "pvlt_v2_tiny"])
def test_serving_logits_match_the_port(name):
    _, model, sd, arch = port_model(name, itm=True, mlm=False, t2i=False)
    g = np.random.default_rng(0)
    imgs = torch.from_numpy(g.random((3, 64, 64, 3), np.float32))
    ids = torch.from_numpy(g.integers(0, 1100, (3, 8)))
    with torch.no_grad():
        got = model.eval()(imgs, ids)["itm_logits"].reshape(-1, 2)
        want = ref.serve_itm(arch, sd, imgs, ids)
    # float32 in another order: with the benchmark's weights the port's own
    # float32 logits lie up to 2.4e-5 from the reference's in float64
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["pvlt_tiny", "pvlt_v2_tiny"])
def test_training_steps_match_the_port(name):
    from mvlt_tpu_torch.config import OptimConfig
    from mvlt_tpu_torch.train.state import create_train_state
    from mvlt_tpu_torch.train.step import make_train_step

    mcfg, model, sd, arch = port_model(name, itm=True, mlm=True, t2i=True)
    b, t, v, spe = 4, 8, 1100, 10
    oc = OptimConfig(batch_size=b)
    st = create_train_state(model, oc, b, spe, seed=77)
    step = make_train_step(mcfg)
    g = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        im = g.random((b, 64, 64, 3), np.float32)
        batches.append({
            "images": torch.from_numpy(im),
            "masked_images": torch.from_numpy(im * (g.random((b, 64, 64, 1)) > 0.5)),
            "input_ids": torch.from_numpy(g.integers(0, v, (b, t)).astype(np.int32)),
            "mlm_labels": torch.from_numpy(
                np.where(g.random((b, t)) < 0.3, g.integers(0, v, (b, t)), -1).astype(np.int32)),
            "itm_labels": torch.from_numpy(g.integers(0, 2, b).astype(np.int32))})
    got_losses = []
    for i in range(3):
        st, losses = step(st, batches[i])
        got_losses.append(float(losses["total_loss"]))
        if i == 0:
            got_grad = {n: st.optimizer.state[p]["exp_avg"] / 0.1
                        for n, p in model.named_parameters()}
    params = {n: sd[n].clone().requires_grad_(True) for n, _ in model.named_parameters()}
    bufs = {k: w for k, w in sd.items() if k not in params}
    gen, state = torch.Generator().manual_seed(77), {}
    peak = oc.lr * b / 512
    for i in range(3):
        ls = ref.pretrain_losses(arch, {**bufs, **params}, batches[i], i % 2 == 1, gen)
        grads = torch.autograd.grad(ls["total_loss"], list(params.values()))
        grads = dict(zip(params, grads))
        if i == 0:
            ref_grad = {n: g.detach().clone() for n, g in grads.items()}
            # float32 sums in another order: each leaf within 1e-4 of its norm
            for n in params:
                assert float((got_grad[n] - grads[n]).norm()) <= 1e-4 * float(grads[n].norm()) + 1e-12
        assert got_losses[i] == pytest.approx(float(ls["total_loss"].detach()), rel=1e-5)
        lr = ref.warmup_cosine_lr(i, peak, oc.warmup_lr, oc.min_lr, oc.warmup_epochs * spe,
                                  oc.epochs * spe)
        with torch.no_grad():
            ref.adamw_update(params, grads, state, i + 1, lr, oc.weight_decay)
    # the change over the elements the check counts: Adam makes whole steps
    # of round-off where a gradient is nought (a key's bias under softmax)
    # (the check's measure: against the larger of the leaf's and the median
    # leaf's norm; a LayerNorm scale at 1.0 moves by a few float32 steps in
    # three steps of an LR near 1e-6, so the change matches to 1e-2)
    norms = {n: float(g.norm()) for n, g in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    rms = float(np.median([norms[n] / max(g.numel(), 1) ** 0.5 for n, g in ref_grad.items()]))
    keep = [n for n in norms if norms[n] >= 1e-3 * med]
    masks = {n: ref_grad[n].abs() >= 1e-3 * rms for n in keep}
    got = {n: float((p.detach() - sd[n])[masks[n]].norm())
           for n, p in model.named_parameters() if n in keep}
    want = {n: float((params[n].detach() - sd[n])[masks[n]].norm()) for n in keep}
    med_want = float(np.median([want[n] for n in keep]))
    gaps = {n: abs(got[n] - want[n]) / max(want[n], med_want) for n in keep}
    leaf = max(gaps, key=gaps.get)
    assert gaps[leaf] < 1e-2, leaf
