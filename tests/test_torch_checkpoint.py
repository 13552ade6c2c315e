"""Training checkpoints of the port (``checkpoint/saving.py``, the engine's
``save_checkpoint`` / ``load_checkpoint``, ``hf_export.checkpoint_to_hf``)
against the JAX package's, on the CPU, in fp32 unless a case says
otherwise.  Every comparison is bit for bit:

* a JAX engine's checkpoint loads into the port, and the port writes it
  back unchanged (every array of the JAX file, and the counters); the
  port's checkpoint loads into a fresh JAX engine without a "checkpoint
  missing" warning, which writes it back unchanged too: fused AdamW,
  lamb and lion;
* save -> load into a fresh engine -> 4 steps gives the losses and the
  fp32 master of 4 unbroken steps, for every optimizer and every offload
  variant the port has (none, cpu, nvme, SuperOffload, ZenFlow with a
  slow pass in flight at the save, offload_param), with fp16 loss-scale
  state, gas > 1 and a save between micro-steps;
* ``client_state``, the lr scheduler's state and
  ``load_optimizer_states=False`` as in the JAX ``checkpoint/saving.py``
  (the JAX engine's ``load_checkpoint`` drops the two flags), and under
  NVMe offload fresh moments whatever the spill directory holds;
* ``checkpoint_to_hf`` writes the files JAX's writes from the same
  checkpoint, and refuses a wrong config with JAX's message;
* partitioned requests raise naming ROADMAP #8.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import hf_export as jx
from deepspeed_tpu.checkpoint import saving as jsaving
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.checkpoint import hf_export as tx
from deepspeed_tpu_torch.checkpoint import hf_import as ti
from deepspeed_tpu_torch.checkpoint import saving as tsaving
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import params_to_numpy

torch.set_num_threads(2)

LR = 1e-3


def _ds(opt="AdamW", oparams=None, dtype="fp32", gas=1, zero=None, **extra):
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas,
          "optimizer": {"type": opt, "params": {"lr": LR, "weight_decay": 0.1,
                                                **(oparams or {})}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 1, **(zero or {})}}
    if dtype == "bf16":
        ds["bf16"] = {"enabled": True}
    if dtype == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}
    ds.update(extra)
    return ds


def _tree(seed=0):
    cfg = jllama.llama_config("tiny", max_seq_len=32)
    return jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        cfg, jax.random.PRNGKey(seed)))


def _port(ds, tree=None, seed=0):
    e, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.llama_model("tiny", max_seq_len=32), config=json.loads(json.dumps(ds)),
        model_parameters=tree, device="cpu", seed=seed)
    return e


def _jax(ds, tree):
    e, *_ = deepspeed_tpu.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                                     config=json.loads(json.dumps(ds)),
                                     model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    return e


def _batches(n, gas=1, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (gas, 2, 17)) for _ in range(n)]


def _arrays(path):
    with np.load(os.path.join(path, tsaving.MODEL_FILE)) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(got, want, skip=()):
    for k, w in want.items():
        if k.startswith(skip):
            continue
        assert k in got, k
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


class _Recorder:
    """Stands in for a module's logger, keeping its warnings."""

    def __init__(self, real):
        self.real, self.warnings = real, []

    def warning(self, msg, *a, **k):
        self.warnings.append(str(msg))

    def __getattr__(self, name):
        return getattr(self.real, name)


# --------------------------------------------------- crossing the packages
@pytest.mark.parametrize("opt,oparams", [("AdamW", {"fused_kernel": True}), ("lamb", {}),
                                         ("lion", {})], ids=["fused_adamw", "lamb", "lion"])
def test_checkpoints_cross_between_the_packages(opt, oparams, tmp_path, monkeypatch):
    tree = _tree()
    ds = _ds(opt, oparams)
    je = _jax(ds, tree)
    for b in _batches(2):
        je.train_batch(jnp.asarray(b, jnp.int32))
    jpath = je.save_checkpoint(str(tmp_path / "jax"))

    te = _port(ds, seed=7)  # other weights: everything must come from the file
    path, client = te.load_checkpoint(str(tmp_path / "jax"))
    assert path == jpath and client == {}
    assert te.global_steps == je.global_steps == 2 and int(te.state.step) == 2
    assert te.get_global_grad_norm() == je.get_global_grad_norm()
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                      je.get_params()))
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(te.get_params())))
    for p, w in want:
        assert np.array_equal(got[p], w), jax.tree_util.keystr(p)
    tpath = te.save_checkpoint(str(tmp_path / "port"))
    jfile, tfile = _arrays(jpath), _arrays(tpath)
    _assert_same_arrays(tfile, jfile)  # params, optimizer state, counters
    assert set(tfile) == set(jfile)

    rec = _Recorder(jsaving.logger)
    monkeypatch.setattr(jsaving, "logger", rec)
    je2 = _jax(ds, jax.tree_util.tree_map(lambda a: a * 0, tree))
    je2.load_checkpoint(str(tmp_path / "port"))
    assert not [w for w in rec.warnings if "checkpoint missing" in w], rec.warnings
    assert je2.global_steps == 2
    jpath2 = je2.save_checkpoint(str(tmp_path / "jax2"))
    _assert_same_arrays(_arrays(jpath2), tfile)
    # and the two engines step on together
    b = _batches(1, seed=9)[0]
    lj, lt = float(je.train_batch(jnp.asarray(b, jnp.int32))), float(te.train_batch(b))
    assert abs(lj - lt) <= 1e-5 * abs(lj)


def test_offload_checkpoint_loads_into_jax_with_its_host_state_apart(tmp_path, monkeypatch):
    """Under offload the port writes the compute-dtype params as the JAX
    engine does, and the host master and moments under ``.offload[...]``
    (the JAX save omits them: ROADMAP #F6), which the JAX loader skips."""
    ds = _ds(dtype="bf16", zero={"stage": 2, "offload_optimizer": {"device": "cpu"}})
    tree = _tree()
    te = _port(ds, tree)
    for b in _batches(2):
        te.train_batch(b)
    path = te.save_checkpoint(str(tmp_path))
    arrays = _arrays(path)
    meta = json.load(open(os.path.join(path, tsaving.META_FILE)))
    assert arrays[".params['embed']['tok']"].dtype == np.uint16
    assert ".params['embed']['tok']" in meta["bfloat16_keys"]
    assert arrays[".offload['master']['layers']['attn']['wq']"].shape == (2, 64, 64)
    master = params_to_numpy(te.get_params())
    assert np.array_equal(arrays[".offload['master']['layers']['attn']['wq']"],
                          master["layers"]["attn"]["wq"])
    rec = _Recorder(jsaving.logger)
    monkeypatch.setattr(jsaving, "logger", rec)
    je = _jax(ds, tree)
    je.load_checkpoint(str(tmp_path))
    assert not [w for w in rec.warnings if "checkpoint missing" in w], rec.warnings
    jp = je.save_checkpoint(str(tmp_path / "jax"))
    _assert_same_arrays(_arrays(jp), arrays, skip=(".offload",))


# ------------------------------------------------- resume is the unbroken run
RESUME = {
    "adamw": _ds(),
    "fused_adamw_bf16": _ds(oparams={"fused_kernel": True}, dtype="bf16"),
    "adam_mu_bf16": _ds("Adam", {"mu_dtype": "bf16"}, dtype="bf16"),
    "lamb": _ds("lamb"),
    "lion": _ds("lion"),
    "adagrad": _ds("adagrad"),
    "sgd": _ds("sgd", {"momentum": 0.9}),
    "muon": _ds("muon"),
    "onebitadam": _ds("onebitadam", {"freeze_step": 3}),
    "zerooneadam": _ds("zerooneadam", {"var_freeze_step": 3, "var_update_interval": 2}),
    "onebitlamb": _ds("onebitlamb", {"freeze_step": 3}),
    "fp16_gas2": _ds(oparams={"fused_kernel": True}, dtype="fp16", gas=2),
    "offload_cpu_bf16": _ds(dtype="bf16", zero={"offload_optimizer": {"device": "cpu"}}),
    "offload_cpu_fp16_gas2": _ds(dtype="fp16", gas=2,
                                 zero={"offload_optimizer": {"device": "cpu"}}),
    "offload_cpu_lion": _ds("lion", zero={"offload_optimizer": {"device": "cpu"}}),
    "offload_cpu_adagrad": _ds("adagrad", zero={"offload_optimizer": {"device": "cpu"}}),
    "offload_nvme": _ds(dtype="bf16", zero={"offload_optimizer": {"device": "nvme"}}),
    "superoffload": _ds(dtype="bf16", zero={"offload_optimizer": {
        "device": "cpu", "super_offload": True, "cpu_worker_count": 3}}),
    "superoffload_nvme": _ds(zero={"offload_optimizer": {
        "device": "nvme", "super_offload": True, "cpu_worker_count": 2}}),
    # interval 2: the save after 3 steps finds the slow pass of step 2 pending
    "zenflow_overlap": _ds(zero={"zenflow": {"enabled": True, "topk_ratio": 0.25,
                                             "update_interval": 2}}),
    "zenflow_inline": _ds(zero={"zenflow": {"enabled": True, "topk_ratio": 0.25,
                                            "update_interval": 2, "overlap_step": False}}),
    "offload_param_bf16": _ds(oparams={"fused_kernel": True}, dtype="bf16",
                              zero={"offload_param": {"device": "cpu"}}),
}


def _resume(ds, tmp_path, steps=3, more=4, gas=1):
    ds = json.loads(json.dumps(ds))
    off = ds["zero_optimization"].get("offload_optimizer", {})
    if off.get("device") == "nvme":
        off["nvme_path"] = str(tmp_path / "nvme_a")
    batches = _batches(steps + more, gas)
    a = _port(ds, _tree())
    for b in batches[:steps]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ck"))
    la = [float(a.train_batch(b)) for b in batches[steps:]]
    if off.get("device") == "nvme":
        off["nvme_path"] = str(tmp_path / "nvme_b")
    # other weights, the same tree (so the leaves sum into the global norm
    # in the same order)
    b_ = _port(ds, _tree(seed=1))
    path, _ = b_.load_checkpoint(str(tmp_path / "ck"))
    assert path.endswith(f"global_step{steps}") and b_.global_steps == steps
    lb = [float(b_.train_batch(b)) for b in batches[steps:]]
    assert la == lb
    for x, y in zip(jax.tree_util.tree_leaves(params_to_numpy(a.get_params())),
                    jax.tree_util.tree_leaves(params_to_numpy(b_.get_params()))):
        assert np.array_equal(x, y)
    assert a.skipped_steps == b_.skipped_steps and a.loss_scale() == b_.loss_scale()
    return a, b_


@pytest.mark.parametrize("case", sorted(RESUME))
def test_resume_is_bit_equal_to_the_unbroken_run(case, tmp_path):
    ds = RESUME[case]
    a, b = _resume(ds, tmp_path, gas=ds["gradient_accumulation_steps"])
    if case.startswith("zenflow_overlap"):
        # the slow pass pending at the save was saved unmerged
        assert ".offload['pending_master']['embed']['tok']" in _arrays(
            str(tmp_path / "ck" / "global_step3"))


def test_save_between_micro_steps_resumes_the_accumulation(tmp_path):
    """A save after a forward/backward micro-step of gas 2 carries the
    accumulation buffer; the resumed engine finishes the step as the
    unbroken one does."""
    ds = _ds(gas=2)
    bs = _batches(3, gas=2)
    a = _port(ds, _tree())
    a.train_batch(bs[0])
    a.forward(bs[1][0])
    a.backward()
    a.save_checkpoint(str(tmp_path))

    def finish(e):
        e.forward(bs[1][1])
        e.backward()
        e.step()
        return float(e.train_batch(bs[2]))

    b = _port(ds, _tree(seed=1))
    b.load_checkpoint(str(tmp_path))
    assert b.state.micro_step == 1 and b.micro_steps == a.micro_steps == 3
    assert finish(a) == finish(b)
    for x, y in zip(jax.tree_util.tree_leaves(params_to_numpy(a.get_params())),
                    jax.tree_util.tree_leaves(params_to_numpy(b.get_params()))):
        assert np.array_equal(x, y)


# ------------------------------------------ client state, scheduler, options
def test_client_state_scheduler_and_optimizer_flag_as_in_jax(tmp_path):
    ds = _ds(scheduler={"type": "WarmupLR", "params": {"warmup_num_steps": 10,
                                                       "warmup_max_lr": LR}})
    tree = _tree()
    je, te = _jax(ds, tree), _port(ds, tree)
    for b in _batches(2):
        je.train_batch(jnp.asarray(b, jnp.int32))
        te.train_batch(b)
    for e in (je, te):
        e.lr_scheduler.step(3)
    client = {"epoch": 4, "note": "x"}
    jp = je.save_checkpoint(str(tmp_path / "j"), client_state=client)
    tp = te.save_checkpoint(str(tmp_path / "t"), client_state=client)
    jmeta = json.load(open(os.path.join(jp, jsaving.META_FILE)))
    tmeta = json.load(open(os.path.join(tp, tsaving.META_FILE)))
    for k in ("global_steps", "micro_steps", "lr_scheduler", "client_state", "zero_stage"):
        assert tmeta[k] == jmeta[k], k
    for flags in [(True, True), (False, False), (True, False), (False, True)]:
        j2, t2 = _jax(ds, tree), _port(ds, tree)
        # the JAX engine's method drops these flags; its saving module's
        # load_checkpoint honours them, and the port's engine does the same
        _, jc = jsaving.load_checkpoint(j2, str(tmp_path / "j"), load_optimizer_states=flags[0],
                                        load_lr_scheduler_states=flags[1])
        _, tc = t2.load_checkpoint(str(tmp_path / "j"), load_optimizer_states=flags[0],
                                   load_lr_scheduler_states=flags[1])
        assert tc == jc == client
        assert t2.lr_scheduler.state_dict() == j2.lr_scheduler.state_dict()
        assert t2.global_steps == j2.global_steps
        # the optimizer state loaded, or left as the fresh engine's
        jf = _arrays(j2.save_checkpoint(str(tmp_path / f"j{flags}")))
        tf = _arrays(t2.save_checkpoint(str(tmp_path / f"t{flags}")))
        _assert_same_arrays(tf, jf)



@pytest.mark.parametrize("case", ["offload_nvme", "superoffload_nvme"])
def test_fresh_optimizer_state_under_nvme_reads_no_old_spill_file(case, tmp_path):
    """``load_optimizer_states=False`` under NVMe loads the master and
    leaves the fresh engine's moments unmade, so its steps are those of a
    new engine from that master: in a spill directory that holds another
    engine's moment files (written after the save) as in an empty one."""
    ds = json.loads(json.dumps(RESUME[case]))
    off = ds["zero_optimization"]["offload_optimizer"]
    off["nvme_path"] = str(tmp_path / "nvme")
    batches = _batches(6)
    a = _port(ds, _tree())
    for b in batches[:3]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ck"))
    master = jax.tree_util.tree_map(np.copy, params_to_numpy(a.get_params()))
    a.train_batch(batches[3])
    assert any(f.startswith("m_") for f in os.listdir(tmp_path / "nvme"))
    runs = {}
    for name in ("old_files", "empty", "new_engine"):
        off["nvme_path"] = str(tmp_path / ("nvme" if name == "old_files" else f"nvme_{name}"))
        if name == "new_engine":
            e = _port(ds, master)
        else:
            e = _port(ds, _tree(seed=1))
            e.load_checkpoint(str(tmp_path / "ck"), load_optimizer_states=False)
            assert e.global_steps == 3
        runs[name] = ([float(e.train_batch(b)) for b in batches[3:]],
                      jax.tree_util.tree_leaves(params_to_numpy(e.get_params())))
    want_losses, want = runs["new_engine"]
    for name in ("old_files", "empty"):
        losses, got = runs[name]
        assert losses == want_losses, name
        for x, y in zip(got, want):
            assert np.array_equal(x, y), name


# ------------------------------------------------------ checkpoint_to_hf
def test_checkpoint_to_hf_writes_jax_files(tmp_path):
    ds = _ds()
    tree = _tree()
    je = _jax(ds, tree)
    je.train_batch(jnp.asarray(_batches(1)[0], jnp.int32))
    je.save_checkpoint(str(tmp_path / "ck"), tag="t1")
    jcfg = jllama.llama_config("tiny", max_seq_len=32)
    tcfg = ti.config_from_hf(jx.hf_config_dict(jcfg, "llama"))
    jx.checkpoint_to_hf(str(tmp_path / "ck"), "t1", str(tmp_path / "jhf"), jcfg)
    tx.checkpoint_to_hf(str(tmp_path / "ck"), "t1", str(tmp_path / "thf"), tcfg)
    assert json.load(open(tmp_path / "thf" / "config.json")) == \
        json.load(open(tmp_path / "jhf" / "config.json"))
    got = ti.read_safetensors(str(tmp_path / "thf" / "model.safetensors"))
    want = ti.read_safetensors(str(tmp_path / "jhf" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # a bf16 offload checkpoint of the port exports its bf16 leaves
    te = _port(_ds(dtype="bf16", zero={"offload_optimizer": {"device": "cpu"}}), tree)
    te.train_batch(_batches(1)[0])
    te.save_checkpoint(str(tmp_path / "ck"), tag="t2")
    jx.checkpoint_to_hf(str(tmp_path / "ck"), "t2", str(tmp_path / "jhf2"), jcfg)
    tx.checkpoint_to_hf(str(tmp_path / "ck"), "t2", str(tmp_path / "thf2"), tcfg)
    got = ti.read_safetensors(str(tmp_path / "thf2" / "model.safetensors"))
    want = ti.read_safetensors(str(tmp_path / "jhf2" / "model.safetensors"))
    assert got["model.embed_tokens.weight"].dtype == torch.bfloat16
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a wrong config is refused with JAX's message
    import dataclasses

    with pytest.raises(ValueError) as w:
        jx.checkpoint_to_hf(str(tmp_path / "ck"), "t1", str(tmp_path / "x"),
                            dataclasses.replace(jcfg, n_layers=3))
    with pytest.raises(ValueError) as g:
        tx.checkpoint_to_hf(str(tmp_path / "ck"), "t1", str(tmp_path / "x"),
                            dataclasses.replace(tcfg, n_layers=3))
    assert str(g.value) == str(w.value)


# ---------------------------------------------------------- partitioned
def test_partitioned_requests_name_their_item(tmp_path):
    te = _port(_ds())
    te.train_batch(_batches(1)[0])
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        te.save_checkpoint(str(tmp_path), partitioned=True)
    path = te.save_checkpoint(str(tmp_path))
    open(os.path.join(path, tsaving.PARTITIONED_META), "w").write("{}")
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        te.load_checkpoint(str(tmp_path), tag="global_step1")
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        tx.checkpoint_to_hf(str(tmp_path), "global_step1", str(tmp_path / "hf"),
                            te.model.config)
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        _port(_ds(checkpoint={"load_universal": True}))
