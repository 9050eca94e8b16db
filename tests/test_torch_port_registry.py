"""The registry's deeper models in the port, against the JAX package's
parameter trees, on the CPU.

For pvlt_small, pvlt_medium, pvlt_large, pvlt_v2_small and pvlt_swin_small
at their published widths (64/128/320/512, head dim 64) and depths: the
port's state dict has exactly the names and shapes the JAX init's tree
exports to (jax.eval_shape of the init, no JAX forward), loads strictly, and
every block's DropPath rate is the one the JAX model hands that block (the
linspace over the total depth, mvlt_tpu/models/pvlt.py:1051), read from the
JAX modules as the init traces them. pvlt_medium and pvlt_large have never
run a forward in the JAX package (ROADMAP F3); nothing here runs one.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.config import ModelConfig as JaxModelConfig
from mvlt_tpu_torch.config import ModelConfig
from mvlt_tpu_torch.convert import state_dict_from_jax
from mvlt_tpu_torch.models.pvlt import PVLT, Block, SwinBlock
from mvlt_tpu_torch.models.registry import resolve_model_config, validate_model_config
from tests.test_torch_port_train import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

DEEPER = ("pvlt_small", "pvlt_medium", "pvlt_large", "pvlt_v2_small", "pvlt_swin_small")
SIZE = 256


def _jax_tree_and_rates(name):
    """(params, batch_stats) of the JAX init as zeros of their shapes, and
    the drop_path of each JAX Block in the order the init calls them."""
    from mvlt_tpu.models import create_model as jax_create_model
    from mvlt_tpu.models.pvlt import Block as JaxBlock

    model = jax_create_model(JaxModelConfig(name=name, use_pallas_attention=False))
    rates = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBlock) and context.method_name == "__call__":
            rates.append(context.module.drop_path)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 128), jnp.int32))
    zeros = lambda s: np.zeros(s.shape, np.float32)
    return (jax.tree_util.tree_map(zeros, shapes["params"]),
            jax.tree_util.tree_map(zeros, shapes["batch_stats"]), rates)


@pytest.mark.parametrize("name", DEEPER)
def test_deeper_model_matches_the_jax_tree(name):
    params, stats, jax_rates = _jax_tree_and_rates(name)
    cfg = resolve_model_config(ModelConfig(name=name))
    validate_model_config(cfg)
    with torch.device("meta"):       # names, shapes and rates only: nothing allocated
        port = PVLT(cfg, SIZE)
    want = state_dict_from_jax(params, stats)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                          for k, v in want.items()}
    port.load_state_dict(want, strict=True, assign=True)    # strict: names and shapes
    blocks = [m for m in port.modules() if isinstance(m, (Block, SwinBlock))]
    assert len(blocks) == sum(port.cfg.depths) == len(jax_rates)
    assert [b.drop_path for b in blocks] == [float(r) for r in jax_rates]
    assert jax_rates[0] == 0.0 and jax_rates[-1] == pytest.approx(port.cfg.drop_path_rate)
    assert all(isinstance(b, SwinBlock) for b in blocks) == (port.cfg.variant == "swin")
    assert all(getattr(b, "v2", False) for b in blocks) == (port.cfg.variant == "v2")
