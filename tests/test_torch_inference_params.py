"""``init_inference`` never alters a ``ParamTree`` its caller passes in.

A tree already on the engine's device in the engine's dtype is used as it
is (the hybrid engine hands over its live leaves: no second copy);
anything else is copied leaf by leaf, as the JAX engine builds new
arrays.  Checked on the CPU: the caller's fp32 tree keeps its dtype and
its bits, the training engine's fp32 master survives a bf16
``init_inference(model, params=engine.get_params())`` and its next
fused-Adam step (the plain update on the CPU) gives the bits of a run
without it, and the greedy tokens equal those of an engine given a bf16
copy (compared exactly)."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.runtime.precision import cast_tree_copy
from test_torch_offload import _batches, _ds, _port, _tree

torch.set_num_threads(2)


def _leaves(tree):
    return [p.detach().clone() for p in tree.parameters()]


def _same(tree, saved):
    return all(p.dtype == s.dtype and torch.equal(p.detach(), s)
               for p, s in zip(tree.parameters(), saved))


@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_init_inference_leaves_the_callers_fp32_tree(dtype):
    _, tree = _tree()
    model = llama_model("tiny", max_seq_len=32)
    params = params_from_numpy(tree, model.config, "cpu", torch.float32)
    saved = _leaves(params)
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": dtype}, params=params,
                                             device="cpu")
    assert _same(params, saved)  # dtype and bits as they were
    want_dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}[dtype]
    assert all(p.dtype == want_dtype for p in eng.params.parameters())
    ref = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": dtype}, params=params.map(lambda t: t.to(want_dtype)),
        device="cpu")
    prompt = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 6)))
    assert torch.equal(eng.generate(prompt, max_new_tokens=5),
                       ref.generate(prompt, max_new_tokens=5))
    eng.module_quantize()  # in place, on the engine's own copy only
    assert _same(params, saved)


def test_tree_in_place_already_is_used_as_it_is():
    """The hybrid engine's case: no copy of a tree that already lies on
    the device in the engine's dtype."""
    _, tree = _tree()
    model = llama_model("tiny", max_seq_len=32)
    params = params_from_numpy(tree, model.config, "cpu", torch.bfloat16)
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"}, params=params,
                                             device="cpu")
    assert eng.params is params
    assert cast_tree_copy(params, torch.bfloat16, torch.device("cpu")) is params


def test_a_mixed_tree_is_copied_whole():
    _, tree = _tree()
    model = llama_model("tiny", max_seq_len=32)
    params = params_from_numpy(tree, model.config, "cpu", torch.bfloat16)
    params.final_norm.scale.data = params.final_norm.scale.data.float()
    saved = _leaves(params)
    got = cast_tree_copy(params, torch.bfloat16, torch.device("cpu"))
    assert got is not params and _same(params, saved)
    assert all(p.dtype == torch.bfloat16 for p in got.parameters())
    assert not ({p.data_ptr() for p in got.parameters()}
                & {p.data_ptr() for p in params.parameters()})


def test_training_master_survives_and_the_next_step_is_unchanged():
    """``init_inference(model, params=engine.get_params())`` in bf16: the
    engine's master stays fp32 with its bits, and the next optimizer step
    (fused AdamW configured) gives the bits of a run that never served."""
    ds = _ds("bf16")
    _, tree = _tree()
    batches = _batches(3)
    served, plain = _port(ds, tree), _port(ds, tree)
    for e in (served, plain):
        e.train_batch(batches[0])
    master = served.get_params()
    saved = _leaves(master)
    eng = deepspeed_tpu_torch.init_inference(llama_model("tiny", max_seq_len=32),
                                             config={"dtype": "bf16"}, params=master,
                                             device="cpu")
    eng.generate(np.zeros((1, 4), np.int64), max_new_tokens=3)
    assert _same(served.get_params(), saved)
    assert all(p.dtype == torch.float32 for p in served.get_params().parameters())
    losses = [(served.train_batch(b), plain.train_batch(b)) for b in batches[1:]]
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in losses)
    assert _same(served.get_params(), _leaves(plain.get_params()))


@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_engine_v2_leaves_the_callers_fp32_tree(dtype):
    """``InferenceEngineV2`` likewise (#F11): a caller's fp32 tree served in
    another dtype keeps its dtype and bits, and the engine's greedy tokens
    equal those of an engine given a copy already in that dtype."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                                  RaggedRequest)

    _, tree = _tree()
    model = llama_model("tiny", max_seq_len=32)
    params = params_from_numpy(tree, model.config, "cpu", torch.float32)
    saved = _leaves(params)
    cfg = RaggedInferenceConfig(dtype=dtype, page_size=8, max_seqs=2, max_pages_per_seq=4,
                                num_pages=8)
    eng = InferenceEngineV2(model, cfg, params=params, device="cpu")
    assert _same(params, saved)
    assert all(p.dtype == cfg.torch_dtype for p in eng.params.parameters())
    copy = cast_tree_copy(params, cfg.torch_dtype, torch.device("cpu"))
    ref = InferenceEngineV2(model, cfg, params=copy, device="cpu")
    assert ref.params is copy  # already there in its dtype: served as it is
    reqs = [RaggedRequest(prompt_ids=[3, 5, 7, 9], max_new_tokens=4)]
    assert eng.generate_all(reqs) == ref.generate_all(reqs)
    assert _same(params, saved)


def test_module_quantize_leaves_a_tree_served_as_it_is():
    """#F12: an engine serving its caller's tree as it is (already on the
    device in its dtype) quantizes a copy; the caller's leaves keep their
    bits, and the engine's quantized tree equals one from an engine given
    a copy."""
    _, tree = _tree()
    model = llama_model("tiny", max_seq_len=32)
    params = params_from_numpy(tree, model.config, "cpu", torch.float32)
    saved = _leaves(params)
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"}, params=params,
                                             device="cpu")
    assert eng.params is params
    eng.module_quantize()
    assert _same(params, saved) and eng.params is not params
    ref = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "fp32"}, params=params.map(lambda t: t.clone()),
        device="cpu").module_quantize()
    assert all(torch.equal(a, b) for a, b in zip(eng.params.parameters(), ref.params.parameters()))
