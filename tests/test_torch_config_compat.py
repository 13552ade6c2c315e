"""#F10: the deprecated ``zero_optimization.cpu_offload`` key.

The JAX package renames it to ``offload_optimizer`` with a warning
(``ConfigModel.deprecated_fields``) and then fails at ``initialize``: the
bare boolean it holds has no ``enabled``.  The port warns with the same
text and refuses every boolean ``offload_optimizer`` at ``initialize``
with a ``ValueError`` naming both keys, so a config that asked for
ZeRO-Offload never trains without it.  No tolerance: texts and refusals
are compared exactly."""

import logging

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.utils import logging as jlogging
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.utils import logging as tlogging

torch.set_num_threads(2)

WARNING = "Config field 'cpu_offload' is deprecated; use 'offload_optimizer'"


def _ds(cpu_offload):
    return {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 2, "cpu_offload": cpu_offload}}


@pytest.fixture
def captured(caplog):
    """Both packages' loggers (neither propagates to the root) into caplog."""
    loggers = (jlogging.logger, tlogging.logger)
    for lg in loggers:
        lg.addHandler(caplog.handler)
    caplog.set_level(logging.WARNING)
    yield caplog
    for lg in loggers:
        lg.removeHandler(caplog.handler)


def _warnings(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name
            and r.levelno == logging.WARNING]


@pytest.mark.parametrize("cpu_offload", [True, False])
def test_both_packages_warn_with_the_same_text(captured, cpu_offload):
    zero = {"stage": 2, "cpu_offload": cpu_offload}
    jz = jconfig.ZeroConfig.from_dict(zero)
    j_msgs = _warnings(captured, jlogging.logger.name)
    assert j_msgs == [WARNING] and jz.offload_optimizer is cpu_offload
    with pytest.raises(ValueError):
        tconfig.ZeroConfig.from_dict(zero)
    assert _warnings(captured, tlogging.logger.name) == j_msgs


def test_the_port_names_the_deprecated_field_as_the_jax_package_does():
    assert tconfig.ZeroConfig.deprecated_fields() == jconfig.ZeroConfig.deprecated_fields()
    assert tconfig.ConfigModel.deprecated_fields() == jconfig.ConfigModel.deprecated_fields() == {}


@pytest.mark.parametrize("cpu_offload", [True, False])
def test_both_packages_refuse_it_at_initialize(cpu_offload):
    """JAX fails on the boolean's missing ``enabled``; the port refuses with
    a ValueError that says what to write instead.  Before the repair the
    port dropped the key and trained at stage 2 without offload."""
    jm = jllama.llama_model("tiny", max_seq_len=16)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jm.config, jax.random.PRNGKey(0)))
    with pytest.raises(AttributeError, match="enabled"):
        deepspeed_tpu.initialize(model=jm, config=_ds(cpu_offload))
    with pytest.raises(ValueError) as e:
        deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=16),
                                       config=_ds(cpu_offload), model_parameters=tree,
                                       device="cpu")
    assert "cpu_offload" in str(e.value) and 'offload_optimizer: {"device": "cpu"}' in str(e.value)


def test_a_boolean_offload_optimizer_written_directly_is_refused_too():
    with pytest.raises(ValueError, match="offload_optimizer"):
        tconfig.DeepSpeedConfig({"zero_optimization": {"stage": 1, "offload_optimizer": True}})


def test_the_new_key_still_offloads():
    cfg = tconfig.DeepSpeedConfig({"zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}})
    assert cfg.zero_config.offload_optimizer.device == "cpu"
    assert cfg.zero_config.offload_optimizer.enabled
