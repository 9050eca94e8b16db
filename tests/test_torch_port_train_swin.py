"""The port's Swin training step against the JAX package's, on the CPU.

The micro config of tests/test_torch_port_train.py (ITM + MLM + T2I, fp32,
DropPath and BERT dropout off, B = 40) as ``pvlt_swin_tiny`` built for and
run at 96x96: stage grids 24, 12, 6 and 3, so stage 1 has three windows of 8
a side, stage 2's 12x12 grid pads to 16 (padded cells masked), stages 3 and
4 take windows of 6 and 3 (odd: a shift of 1), and every odd block shifts.
The JAX side runs SwinJointAttention's einsum branch and the XLA Mlp
(use_pallas_attention=False). At step 0, step 1 (masked images) and
train_mode=False the losses agree to 2e-4, every gradient (the
relative-position tables' too) to 1e-3 of its tensor's largest magnitude
and the BatchNorm statistics to 2e-4. Then the routing: training and a
gradient wanted take the joint stream and the einsum route at every stage,
serving the split stream where kernel E's gate holds.
"""

import numpy as np
import pytest
import torch

from mvlt_tpu import config as jax_config
from mvlt_tpu_torch import config
from mvlt_tpu_torch.models.pvlt import SwinBlock, create_model
from mvlt_tpu_torch.models.swin import SwinJointAttention, position_bias, window_attention
from mvlt_tpu_torch.ops.swin_attention import swin_attention_reference
from tests.test_torch_port_train import (HEADS, MICRO, build_jax_step, check_step_against_jax,
                                         one_torch_thread)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

IMG = 96


def _configs(**extra):
    micro = {**MICRO, "img_size": IMG, **extra}
    return (jax_config.ModelConfig(**micro, name="pvlt_swin_tiny", use_pallas_attention=False,
                                   loss_type=jax_config.LossType(**HEADS)),
            config.ModelConfig(**micro, name="pvlt_swin_tiny",
                               loss_type=config.LossType(**HEADS)))


@pytest.fixture(scope="module")
def swin_step():
    return build_jax_step(*_configs(), img=IMG)


@pytest.mark.parametrize("step,train_mode", [(0, True), (1, True), (0, False)])
def test_swin_step_matches_jax(swin_step, step, train_mode):
    check_step_against_jax(swin_step, swin_step[1], step, train_mode)


def test_window_attention_equals_kernel_f_plain_version():
    """The differentiable window attention (bias, then the mask, added to
    the logits) and kernel F's plain version (one additive table) agree on
    a padded, shifted grid with a text block."""
    gen = torch.Generator().manual_seed(0)
    attn = SwinJointAttention(16, 2, 8, True, True, 8)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(generator=gen)
    hw, t = (12, 12), 5
    index, mask = attn._static(hw, "cpu")
    q, k, v = (torch.randn(3, 4, 2, 64, 8, generator=gen) for _ in range(3))
    kt, vt = (torch.randn(3, 2, t, 8, generator=gen) for _ in range(2))
    bias = position_bias(attn.relative_position_bias_table, index)
    got = window_attention(q, k, v, kt, vt, bias, mask, scale=8 ** -0.5)
    want = swin_attention_reference(q, k, v, kt, vt, attn.add_table(hw, t), scale=8 ** -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_training_takes_the_joint_stream_at_every_stage():
    """Kernel E's split stream needs eval mode and no gradient wanted
    (mvlt_tpu/models/pvlt.py:73-86): a training forward, and an eval forward
    with gradients, hand every block the joint stream; a no-grad eval
    forward hands the band stages (here stage 1, 24x24 in windows of 8,
    and stage 3, 6x6 in one window of 6) the split one."""
    _, pcfg = _configs()
    model = create_model(pcfg, device="cpu", input_size=IMG)
    seen = []
    for blk in model.modules():
        if isinstance(blk, SwinBlock):
            blk.register_forward_pre_hook(lambda m, args: seen.append(torch.is_tensor(args[0])))
    images, ids = torch.rand(2, IMG, IMG, 3), torch.zeros(2, 16, dtype=torch.long)
    model.train()(images, ids)
    model.eval()(images, ids)
    assert seen == [True] * 16
    with torch.no_grad():
        model(images, ids)
    assert seen[16:] == [False, False, True, True, False, False, True, True]
