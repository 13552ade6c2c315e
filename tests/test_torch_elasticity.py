"""The port's elastic configuration (``elasticity/elasticity.py``) and
``initialize``'s elastic derivation against the JAX package's, on the CPU.

``compute_elastic_config`` gives the same batch, valid world sizes and
per-world micro batch and gradient accumulation over a grid of elastic
blocks and world sizes, exactly (integer arithmetic), and raises where
JAX raises; ``initialize`` with an elastic block takes the JAX package's
derived micro batch and gas (the port's engine trains on one rank, so at
a world size of 1) and refuses explicit batch sizes unless
``ignore_non_elastic_batch_info``."""

import itertools

import numpy as np
import pytest
import torch

from deepspeed_tpu.elasticity import elasticity as jel
from deepspeed_tpu_torch.elasticity import elasticity as tel

torch.set_num_threads(2)

GRID = list(itertools.product([[2, 4, 6], [1], [3, 5], [8, 16]], [16, 100, 2000],
                              [(1, 10000), (2, 8), (4, 4)]))


def _block(mbs, max_batch, gpus):
    return {"elasticity": {"enabled": True, "micro_batch_sizes": mbs,
                           "max_train_batch_size": max_batch, "min_gpus": gpus[0],
                           "max_gpus": gpus[1]}}


def _outcome(mod, cfg, world):
    try:
        return mod.compute_elastic_config(cfg, world_size=world)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("mbs,max_batch,gpus", GRID,
                         ids=[f"mb{'-'.join(map(str, m))}_max{b}_g{g[0]}-{g[1]}"
                              for m, b, g in GRID])
def test_compute_elastic_config_matches_jax(mbs, max_batch, gpus):
    cfg = _block(mbs, max_batch, gpus)
    for world in (0, 1, 2, 3, 4, 8):
        assert _outcome(tel, cfg, world) == _outcome(jel, cfg, world), world
    assert tel.get_compatible_gpus(mbs, max_batch, *gpus) == \
        jel.get_compatible_gpus(mbs, max_batch, *gpus)


def test_disabled_and_changed_blocks_raise_as_in_jax():
    for mod in (jel, tel):
        with pytest.raises(ValueError, match="not enabled"):
            mod.compute_elastic_config({"elasticity": {"enabled": False}})
        a, b = _block([2, 4], 100, (1, 8)), _block([2, 4], 64, (1, 8))
        mod.ensure_immutable_elastic_config(a, a)
        with pytest.raises(ValueError, match="changed across restarts"):
            mod.ensure_immutable_elastic_config(a, b)
    assert tel.ElasticityConfig().to_dict() == jel.ElasticityConfig().to_dict()


def _init(ds):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    eng, *_ = deepspeed_tpu_torch.initialize(model=llama_model("tiny", max_seq_len=32),
                                            config=ds, device="cpu", seed=0)
    return eng


@pytest.mark.parametrize("mbs,max_batch", [([2, 4], 8), ([1, 3], 6), ([2], 2)])
def test_initialize_derives_the_jax_micro_batch_and_gas(mbs, max_batch):
    ds = {"elasticity": {"enabled": True, "micro_batch_sizes": mbs,
                         "max_train_batch_size": max_batch},
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    batch, _, info = jel.compute_elastic_config(ds, world_size=1)
    eng = _init(ds)
    assert (eng.train_batch_size(), eng.train_micro_batch_size_per_gpu(),
            eng.gradient_accumulation_steps()) == (
        batch, info["micro_batch_per_gpu"], info["gradient_accumulation_steps"])
    ids = np.random.RandomState(0).randint(0, 256, (info["gradient_accumulation_steps"],
                                                    info["micro_batch_per_gpu"], 17))
    assert np.isfinite(float(eng.train_batch(ids)))


def test_initialize_refuses_explicit_batches_unless_told_to_ignore_them():
    ds = {"elasticity": {"enabled": True, "micro_batch_sizes": [2], "max_train_batch_size": 4},
          "train_micro_batch_size_per_gpu": 1}
    with pytest.raises(ValueError, match="batch sizes are set explicitly"):
        _init(ds)
    ds["elasticity"]["ignore_non_elastic_batch_info"] = True
    eng = _init(ds)
    assert (eng.train_micro_batch_size_per_gpu(), eng.gradient_accumulation_steps()) == (2, 2)
