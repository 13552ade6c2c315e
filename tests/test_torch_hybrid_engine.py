"""The hybrid engine (``runtime/hybrid_engine.py``) against the JAX
package's, on the CPU: train, generate, train, generate, in fp32 from the
same weights and batches.  Greedy tokens must equal the JAX engine's
(fp32 logits agree to about 1e-6, far inside the gaps between the top
tokens of a seeded tiny model), and the generation must read the training
engine's live leaves (the inference engine's tensors are the compute
copy's, pointer for pointer), also under offload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
from test_torch_offload import _batches, _ds, _port, _tree

torch.set_num_threads(2)


def _hybrid(**zero):
    ds = _ds("fp32", **zero)
    ds["hybrid_engine"] = {"enabled": True, "max_out_tokens": 6}
    return ds


@pytest.mark.parametrize("zero", [{}, {"offload_optimizer": {"device": "cpu"}}])
def test_train_generate_train_matches_jax(zero):
    ds = _hybrid(**zero)
    jm, tree = _tree()
    je, *_ = deepspeed_tpu.initialize(model=jm, config=dict(ds),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te = _port(ds, tree)
    assert isinstance(te, DeepSpeedHybridEngine)
    prompt = np.random.RandomState(7).randint(0, 256, (2, 5))
    batches = _batches(4)
    for phase in range(2):
        for ids in batches[2 * phase:2 * phase + 2]:
            je.train_batch(jnp.asarray(ids, jnp.int32))
            te.train_batch(ids)
        want = np.asarray(je.generate(jnp.asarray(prompt, jnp.int32)))
        got = te.generate(prompt)
        assert got.shape == (2, 5 + 6) and np.array_equal(got.numpy(), want), phase
        assert not te.in_eval
    ptrs = {p.data_ptr() for p in te._compute.parameters()}
    assert {p.data_ptr() for p in te._inference_engine.params.parameters()} == ptrs


def test_eval_train_and_release_inference_cache():
    _, tree = _tree()
    ds = _hybrid()
    ds["hybrid_engine"]["release_inference_cache"] = True
    te = _port(ds, tree)
    te.eval()
    assert te.in_eval
    te.train()
    assert not te.in_eval
    te.generate(np.zeros((1, 3), np.int64), max_new_tokens=2)
    assert te._inference_engine is None
