"""Activation checkpointing in the port (``runtime/activation_checkpointing/
checkpointing.py`` and ``TransformerConfig.remat``) against the JAX
package's, on the CPU.

* The module maps every ``POLICY_MAP`` name as the JAX module does (the
  same policy, or None where JAX's is None); ``offload_dots`` and
  ``cpu_checkpointing`` keep the residuals in (pinned) host memory.
* Remat changes no number: for every policy name, ``transformer_forward``
  and ``causal_lm_loss`` give losses and gradients bit-equal to
  ``remat=False`` in fp32 (the recompute runs the same ops on the same
  inputs; an offloaded residual comes back with the bits it left with),
  for llama and for Mixtral (dropless and capacity), also with
  ``cpu_checkpointing``.
* Against JAX's ``remat=True``: the tolerances of ``test_torch_model.py``
  without remat (fp32 1e-5 of each leaf's largest gradient).
* A ``torch.Generator`` handed to the checkpointed function draws the
  forward's noise again in the recompute and is left where it was.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jck
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models import mixtral as tmixtral
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.moe import sharded_moe as tm
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as tck

torch.set_num_threads(2)

OFFLOAD = ("offload_dots",)
POLICIES = sorted(tck.POLICY_MAP)
MODELS = {"llama": (jllama.llama_config, tllama.llama_config, {}),
          "mixtral_dropless": (jmixtral.mixtral_config, tmixtral.mixtral_config,
                               dict(moe_drop_tokens=False)),
          "mixtral_capacity": (jmixtral.mixtral_config, tmixtral.mixtral_config, {})}


@pytest.fixture
def fresh_config(monkeypatch):
    """Both modules' process-wide config, restored after the test."""
    for mod in (jck, tck):
        monkeypatch.setattr(mod, "_CONFIG", dict(mod._CONFIG))


def _setup(model, seed=0, **kw):
    jmake, tmake, extra = MODELS[model]
    jcfg = jmake("tiny", max_seq_len=64, **extra, **kw)
    tcfg = tmake("tiny", max_seq_len=64, **extra, **kw)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, tree


def _port_loss_and_grads(tcfg, tree, ids):
    tp = params_from_numpy(tree, tcfg, "cpu", torch.float32)
    for p in tp.parameters():
        p.requires_grad_(True)
    loss = tt.causal_lm_loss(tcfg, tp, torch.from_numpy(ids))
    loss.backward()
    return loss.detach(), [p.grad for p in tp.parameters()], tp


@pytest.mark.parametrize("name", sorted(tck.POLICY_MAP))
def test_policy_map_matches_jax(name, fresh_config):
    assert tck.POLICY_MAP == jck.POLICY_MAP
    want, got = jck.get_policy(name), tck.get_policy(name)
    assert (got is not None and got.offload) == (name in OFFLOAD)
    if want is None:
        assert got is None
    else:
        assert got.name == want.__name__
    # the configured default goes through configure() as in the JAX module
    jck.configure(policy=name)
    tck.configure(policy=name)
    assert (tck.get_policy() is None) == (jck.get_policy() is None)


def test_unknown_policy_saves_nothing_and_host_memory_raises(fresh_config):
    """An unknown name saves nothing; host-memory checkpointing, which once
    raised, now makes every name the offloading policy, as the JAX
    module's get_policy returns its offload policy whatever the name."""
    assert tck.get_policy("no_such_policy") is None is jck.get_policy("no_such_policy")
    tck.configure(checkpoint_in_cpu=True)
    assert tck.is_configured() and tck._CONFIG["cpu_checkpointing"]
    for name in ("nothing_saveable", "dots_saveable", "no_such_policy"):
        assert tck.get_policy(name).offload


def test_config_block_configures_the_module(fresh_config):
    block = {"partition_activations": True, "number_checkpoints": 4,
             "policy": "dots_saveable", "profile": False}
    cfg = tconfig.DeepSpeedConfig({"activation_checkpointing": block})
    jc = tconfig.ActivationCheckpointingConfig
    assert cfg.activation_checkpointing == jc.from_dict(block)
    assert tck._CONFIG["policy"] == "dots_saveable" and tck._CONFIG["number_checkpoints"] == 4
    assert tck.get_policy().name == "dots_saveable"
    # the JAX config parses the same block to the same fields
    from deepspeed_tpu.runtime import config as jconfig

    jac = jconfig.DeepSpeedConfig({"train_batch_size": 1, "activation_checkpointing": block},
                                  dp_world_size=1).activation_checkpointing
    assert {f: getattr(jac, f) for f in jc.__dataclass_fields__} == \
        dataclasses.asdict(cfg.activation_checkpointing)
    tconfig.DeepSpeedConfig({"activation_checkpointing": {"cpu_checkpointing": True}})
    assert tck._CONFIG["cpu_checkpointing"] and tck.get_policy().offload


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_is_bit_equal_to_no_remat(model, policy):
    """causal_lm_loss's value and every leaf's gradient, and
    transformer_forward's hidden states and aux, with remat and this policy
    bit-equal to remat=False (fp32)."""
    _, tcfg, tree = _setup(model)
    ids = np.random.RandomState(5).randint(0, tcfg.vocab_size, (2, 17))
    rcfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    loss, grads, tp = _port_loss_and_grads(tcfg, tree, ids)
    rloss, rgrads, _ = _port_loss_and_grads(rcfg, tree, ids)
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    with torch.no_grad():
        for a, b in zip(tt.transformer_forward(tcfg, tp, torch.from_numpy(ids)),
                        tt.transformer_forward(rcfg, tp, torch.from_numpy(ids))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_cpu_checkpointing_is_bit_equal_to_no_remat(model, fresh_config):
    """cpu_checkpointing: every residual of each block goes to host memory
    and comes back for the backward; loss and gradients bit-equal."""
    _, tcfg, tree = _setup(model)
    ids = np.random.RandomState(5).randint(0, tcfg.vocab_size, (2, 17))
    loss, grads, _ = _port_loss_and_grads(tcfg, tree, ids)
    tck.configure(checkpoint_in_cpu=True)
    rloss, rgrads, _ = _port_loss_and_grads(dataclasses.replace(tcfg, remat=True), tree, ids)
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_matches_jax_remat(model, policy):
    """The port's remat against JAX's remat=True with the same policy name:
    the loss and every leaf's gradient, fp32, at the limits without remat."""
    jcfg, tcfg, tree = _setup(model)
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy=policy)
    tcfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    ids = np.random.RandomState(6).randint(0, tcfg.vocab_size, (2, 17))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    wl, wg = jax.value_and_grad(lambda p: jt.causal_lm_loss(jcfg, p, jnp.asarray(ids)))(jp)
    loss, _, tp = _port_loss_and_grads(tcfg, tree, ids)
    assert abs(float(loss) - float(wl)) <= 1e-5 * abs(float(wl))
    g = tp.map(lambda t: t)
    for (_, dst), (_, src) in zip(g.named_parameters(), tp.named_parameters()):
        dst.data = src.grad
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(g)))
    for path, w in jax.tree_util.tree_leaves_with_path(wg):
        w = np.asarray(w, np.float32)
        assert np.abs(got[path] - w).max() <= 1e-5 * np.abs(w).max(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_checkpoint_holds_an_explicit_generator(policy):
    """Noisy gating through ``checkpoint``: the recompute draws the forward's
    noise again (gradients equal to the un-checkpointed call's from the same
    generator state), and the generator is left where the forward left it
    (the recompute does not advance it)."""
    E, H = 4, 8
    rng = np.random.RandomState(2)
    ex = {k: torch.from_numpy((rng.randn(E, *s) * 0.3).astype(np.float32)).requires_grad_(True)
          for k, s in (("w_gate", (H, 12)), ("w_up", (H, 12)), ("w_down", (12, H)))}
    gate_w = torch.from_numpy(rng.randn(H, E).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.randn(2, 5, H).astype(np.float32)).requires_grad_(True)
    cfg = tm.MoEConfig(num_experts=E, top_k=2, noisy_gate_policy="RSample", drop_tokens=False)
    leaves = [x, gate_w, *ex.values()]

    def run(fn, gen):
        out, aux = fn(x, gate_w, ex, cfg, "swiglu", gen)
        return torch.autograd.grad((out * out).sum() + aux, leaves)

    want = run(tm.moe_ffn, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    got = run(tck.checkpoint_wrapper(tm.moe_ffn, policy), gen)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    after_one_forward = torch.Generator().manual_seed(3)
    tm.moe_ffn(x, gate_w, ex, cfg, "swiglu", after_one_forward)
    assert torch.equal(gen.get_state(), after_one_forward.get_state())


def test_everything_saveable_runs_the_function_as_is():
    calls = []

    def f(t):
        calls.append(1)
        return (t * t).sum()  # saves t: its backward reads it

    t = torch.ones(3, requires_grad=True)
    tck.checkpoint_wrapper(f, "everything_saveable")(t).backward()
    assert len(calls) == 1 and torch.equal(t.grad, torch.full((3,), 2.0))
    tck.checkpoint_wrapper(f, "nothing_saveable")(t).backward()
    assert len(calls) == 3  # forward and the recompute
