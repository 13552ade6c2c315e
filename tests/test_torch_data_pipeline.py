"""The port's data pipeline (``runtime/data_pipeline/``,
``runtime/dataloader.py``, ``initialize(training_data=...)``) against the
JAX package's, on the CPU.  Everything here is bit for bit, except the
JAX engine's losses, which are held within 1e-5 relative (fp32, the
limit of ``test_torch_engine.py``):

* ``.bin``/``.idx`` files written by either package's builder (and by
  either ``merge_datasets``) are byte-identical and read the same in the
  other;
* the curriculum schedules, ``apply_seqlen_curriculum``, the sampler's
  indices and ``batch_by_token_budget``;
* the analyzer's files on disk (single and several workers, per-sample and
  accumulated metrics) and ``load_difficulties``;
* random-LTD's budget schedule and ``random_ltd_apply`` on the same kept
  positions; PLD's theta schedule, keep probabilities and ``pld_apply``
  on the same keep decision;
* ``initialize(training_data=<MMapIndexedDataset>)`` -> ``train_batch()``
  gives the losses of the same batches fed by hand, in the JAX loader's
  order (at one rank), across an epoch's end; the JAX engine on those
  batches gives the same losses.
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
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime.data_pipeline import curriculum as jcur
from deepspeed_tpu.runtime.data_pipeline import data_analyzer as jda
from deepspeed_tpu.runtime.data_pipeline import data_routing as jdr
from deepspeed_tpu.runtime.data_pipeline import indexed_dataset as jid
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum as tcur
from deepspeed_tpu_torch.runtime.data_pipeline import data_analyzer as tda
from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as tdr
from deepspeed_tpu_torch.runtime.data_pipeline import indexed_dataset as tid

torch.set_num_threads(2)


def _seqs(dtype, n=7, seed=0):
    rng = np.random.RandomState(seed)
    hi = 60000 if dtype == np.uint16 else 30000
    return [rng.randint(0, hi, rng.randint(1, 40)).astype(dtype) for _ in range(n)]


def _build(mod, prefix, seqs, dtype, docs_every=2):
    b = mod.MMapIndexedDatasetBuilder(str(prefix), dtype=dtype)
    for i, s in enumerate(seqs):
        b.add_item(s)
        if (i + 1) % docs_every == 0:
            b.end_document()
    return b.finalize()


def _files(prefix):
    return [open(str(prefix) + ext, "rb").read() for ext in (".bin", ".idx")]


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64])
def test_indexed_files_cross_both_ways(dtype, tmp_path):
    seqs = _seqs(dtype)
    _build(jid, tmp_path / "j", seqs, dtype)
    _build(tid, tmp_path / "t", seqs, dtype)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    for reader, prefix in ((tid, "j"), (jid, "t")):
        ds = reader.MMapIndexedDataset(str(tmp_path / prefix))
        assert len(ds) == len(seqs) and ds.dtype == np.dtype(dtype)
        for want, got in zip(seqs, ds[0:len(seqs)]):
            assert np.array_equal(want, got)
        assert np.array_equal(ds.get(3, offset=1, length=2), seqs[3][1:3])
    other = _seqs(dtype, n=3, seed=1)
    _build(jid, tmp_path / "j2", other, dtype, docs_every=1)
    jid.merge_datasets([str(tmp_path / "j"), str(tmp_path / "j2")], str(tmp_path / "jm"))
    tid.merge_datasets([str(tmp_path / "t"), str(tmp_path / "j2")], str(tmp_path / "tm"))
    assert _files(tmp_path / "jm") == _files(tmp_path / "tm")
    m = tid.make_dataset(str(tmp_path / "jm"))
    assert np.array_equal(m[len(seqs)], other[0])
    assert list(m.doc_idx) == list(jid.MMapIndexedDataset(str(tmp_path / "jm")).doc_idx)


def test_indexed_refusals_match_jax(tmp_path):
    for mod in (jid, tid):
        with pytest.raises(ValueError, match="do not fit"):
            mod.MMapIndexedDatasetBuilder(str(tmp_path / "x"), dtype=np.uint16).add_item(
                np.asarray([70000]))
        with pytest.raises(FileNotFoundError):
            mod.make_dataset(str(tmp_path / "missing"))
    _build(jid, tmp_path / "a", _seqs(np.int32, 2), np.int32)
    _build(jid, tmp_path / "b", _seqs(np.uint16, 2), np.uint16)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tid.merge_datasets([str(tmp_path / "a"), str(tmp_path / "b")], str(tmp_path / "m"))


# ------------------------------------------------------------ curriculum
CURRICULA = [
    {"min_difficulty": 64, "max_difficulty": 1024, "schedule_type": "fixed_linear",
     "total_curriculum_step": 1000, "difficulty_step": 8},
    {"min_difficulty": 32, "max_difficulty": 512,
     "schedule_config": {"schedule_type": "fixed_root", "total_curriculum_step": 300,
                         "difficulty_step": 16, "root_degree": 3}},
    {"schedule_type": "fixed_discrete", "difficulty": [16, 64, 256], "max_step": [10, 100]},
]


@pytest.mark.parametrize("i", range(len(CURRICULA)))
def test_curriculum_schedules_and_sampler_match_jax(i):
    jc = jcur.CurriculumScheduler(jcur.CurriculumConfig.from_dict(CURRICULA[i]))
    tc = tcur.CurriculumScheduler(tcur.CurriculumConfig.from_dict(CURRICULA[i]))
    for step in list(range(0, 1200, 7)) + [10**6]:
        assert tc.update_difficulty(step) == jc.update_difficulty(step)
    batch = {"input_ids": np.arange(2 * 300).reshape(2, 300), "lens": np.arange(2)}
    for d in (16, 64, 512):
        got, want = tcur.apply_seqlen_curriculum(batch, d), jcur.apply_seqlen_curriculum(
            batch, d)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    diffs = np.random.RandomState(i).randint(8, 1100, 200)
    js = jcur.DeepSpeedDataSampler(diffs, jcur.CurriculumScheduler(jc.config), 8, seed=3)
    ts = tcur.DeepSpeedDataSampler(diffs, tcur.CurriculumScheduler(tc.config), 8, seed=3)
    for step in (0, 5, 50, 400, 2000):
        js.set_step(step)
        ts.set_step(step)
        assert np.array_equal(ts.next_indices(), js.next_indices())


@pytest.mark.parametrize("method", ["linear", "sqrt", "none"])
def test_batch_by_token_budget_matches_jax(method):
    lens = np.random.RandomState(2).randint(1, 900, 300)
    jb, jm = jcur.batch_by_token_budget(lens, jcur.VariableBatchConfig(2048, method))
    tb, tm = tcur.batch_by_token_budget(lens, tcur.VariableBatchConfig(2048, method))
    assert tm == jm and len(tb) == len(jb)
    assert all(np.array_equal(a, b) for a, b in zip(tb, jb))


# -------------------------------------------------------------- analyzer
def _corpus(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 50, size=rng.randint(4, 30))} for _ in range(n)]


def _dir_files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("workers", [1, 3])
def test_analyzer_writes_the_jax_files(workers, tmp_path):
    ds = _corpus()
    freq = np.bincount(np.concatenate([s["input_ids"] for s in ds]), minlength=50)
    for mod, sub in ((jda, "j"), (tda, "t")):
        kw = dict(metric_names=["seqlen", "rarity", "vocab"],
                  metric_functions=[mod.metric_seqlen, mod.metric_total_vocab_freq(freq),
                                    mod.metric_vocab_histogram(50)],
                  metric_types=["single_value_per_sample"] * 2
                  + ["accumulate_value_over_samples"])
        mod.DataAnalyzer.run_map_reduce(ds, save_path=str(tmp_path / sub),
                                        num_workers=workers, **kw)
    assert _dir_files(tmp_path / "t") == _dir_files(tmp_path / "j")
    assert np.array_equal(tda.load_difficulties(str(tmp_path / "t"), "rarity"),
                          jda.load_difficulties(str(tmp_path / "j"), "rarity"))
    with pytest.raises(FileNotFoundError):
        tda.DataAnalyzer(ds, save_path=str(tmp_path / "x"), num_workers=2).run_reduce()


# --------------------------------------------------------- data routing
def test_random_ltd_schedule_and_apply_match_jax():
    for kw in ({"enabled": True, "start_token_budget": 16, "schedule_steps": 100},
               {"enabled": False}, {"enabled": True, "start_token_budget": 300}):
        jc, tc = jdr.RandomLTDConfig(**kw), tdr.RandomLTDConfig(**kw)
        for step in range(0, 1100, 13):
            for S in (64, 257):
                assert tc.token_budget(step, S) == jc.token_budget(step, S)
    x = np.random.RandomState(0).randn(3, 16, 8).astype(np.float32)
    keep = np.asarray(jdr.random_ltd_indices(jax.random.PRNGKey(0), 16, 5, 3))
    keep = keep.copy()
    want = np.asarray(jdr.random_ltd_apply(lambda h: h * 2.0 + 1.0, jnp.asarray(x),
                                           jnp.asarray(keep)))
    got = tdr.random_ltd_apply(lambda h: h * 2.0 + 1.0, torch.from_numpy(x),
                               torch.from_numpy(keep))
    assert np.array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(0)
    idx = tdr.random_ltd_indices(g, 16, 5, 3)
    assert idx.shape == (3, 5) and (idx.diff(dim=1) > 0).all() and idx.max() < 16


def test_pld_schedule_and_apply_match_jax():
    jp = jdr.ProgressiveLayerDrop(jdr.PLDConfig(enabled=True, theta=0.5, gamma=0.01))
    tp = tdr.ProgressiveLayerDrop(tdr.PLDConfig(enabled=True, theta=0.5, gamma=0.01))
    assert tp.get_theta() == jp.get_theta() == 1.0
    for step in (0, 1, 7, 100, 1000, 10**6):
        assert tp.update_state(step) == jp.update_state(step)
        assert tp.get_state() == jp.get_state()
        for layer in range(12):
            assert tp.layer_keep_prob(layer, 12) == jp.layer_keep_prob(layer, 12)
    x = np.random.RandomState(1).randn(2, 4, 8).astype(np.float32)

    def fn(h):
        return h * 3.0 - 0.5

    p = 0.6
    keys = {}
    for s in range(64):  # a key that keeps the block and one that drops it
        keys.setdefault(bool(jax.random.bernoulli(jax.random.PRNGKey(s), p)), s)
    for keep, s in keys.items():
        want = np.asarray(jdr.pld_apply(fn, jnp.asarray(x), jax.random.PRNGKey(s), p))
        got = tdr.pld_apply(fn, torch.from_numpy(x), keep, p).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        if not keep:
            assert np.array_equal(got, x)
    for training, kp in ((False, 0.3), (True, 1.0)):
        want = np.asarray(jdr.pld_apply(fn, jnp.asarray(x), jax.random.PRNGKey(0), kp,
                                        training=training))
        got = tdr.pld_apply(fn, torch.from_numpy(x), torch.Generator(), kp,
                            training=training).numpy()
        assert np.array_equal(got, want)
    draws = [tdr.pld_apply(fn, torch.zeros(1), torch.Generator().manual_seed(s), p)
             for s in range(200)]
    kept = sum(bool(d.abs().sum() > 0) for d in draws)
    assert 80 < kept < 160  # ~p of 200


# ------------------------------------------------- training from a dataset
def _corpus_files(tmp_path, n=12, length=17):
    rng = np.random.RandomState(5)
    b = tid.MMapIndexedDatasetBuilder(str(tmp_path / "corpus"), dtype=np.uint16)
    for _ in range(n):
        b.add_item(rng.randint(0, 256, length).astype(np.uint16))
        b.end_document()
    return b.finalize()


def test_training_data_feeds_train_batch(tmp_path):
    """4 steps of gas 2 over 12 sequences of micro-batch 2 run past the
    end of the first epoch (6 micro-batches) into a reshuffled second."""
    prefix = _corpus_files(tmp_path)
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0,
          "seed": 7}
    cfg = jllama.llama_config("tiny", max_seq_len=32)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        cfg, jax.random.PRNGKey(0)))
    data = tid.MMapIndexedDataset(prefix)
    fed, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tllama.llama_model("tiny", max_seq_len=32), config=json.loads(json.dumps(ds)),
        model_parameters=tree, training_data=data, device="cpu")
    assert loader is fed.training_dataloader and len(loader) == 6
    first = next(iter(loader))
    assert first.dtype == torch.int32 and first.shape == (2, 17)  # uint16 widened
    hand, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.llama_model("tiny", max_seq_len=32), config=json.loads(json.dumps(ds)),
        model_parameters=tree, device="cpu")
    order = []
    for epoch in range(2):  # the loader's order: RandomState(seed + epoch) shuffles
        idx = np.arange(len(data))
        np.random.RandomState(7 + epoch).shuffle(idx)
        order += [idx[i:i + 2] for i in range(0, 12, 2)]
    got = [float(fed.train_batch()) for _ in range(4)]
    want = [float(hand.train_batch(np.stack([np.stack([data[int(i)] for i in order[2 * s + m]])
                                             .astype(np.int64) for m in range(2)])))
            for s in range(4)]
    assert got == want
    # the JAX loader's order at one data-parallel rank is the same, and the
    # JAX engine on those batches gives the same losses
    from deepspeed_tpu.runtime import dataloader as jdl

    class OneRank:
        dp_world_size = 1

    jl = jdl.DeepSpeedDataLoader(jid.MMapIndexedDataset(prefix), 2, OneRank(), seed=7)
    for epoch in range(2):
        jl.set_epoch(epoch)
        loader.set_epoch(epoch)
        assert np.array_equal(loader._indices(), jl._indices())
    je, *_ = deepspeed_tpu.initialize(
        model=jllama.llama_model("tiny", max_seq_len=32), config=json.loads(json.dumps(ds)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    jlosses = [float(je.train_batch(jnp.asarray(np.stack([np.stack(
        [data[int(i)] for i in order[2 * s + m]]) for m in range(2)]), jnp.int32)))
        for s in range(4)]
    for a, b in zip(got, jlosses):
        assert abs(a - b) <= 1e-5 * abs(b), (got, jlosses)


def test_dataloader_collates_structures_and_wraps():
    data = [(np.full(3, i, np.uint16), np.float32(i)) for i in range(5)]
    dl = tdl.DeepSpeedDataLoader(data, 2, device="cpu", shuffle=False, drop_last=False)
    batches = list(dl)
    assert len(dl) == 3 and len(batches) == 3 and dl.epoch == 1
    x, y = batches[2]
    assert x.dtype == torch.int32 and x.tolist() == [[4] * 3, [0] * 3]  # wrapped
    assert y.dtype == torch.float32 and y.tolist() == [4.0, 0.0]
    rep = tdl.RepeatingLoader(dl)
    assert len([next(rep) for _ in range(7)]) == 7
    d = tdl.default_collate([{"a": np.ones(2, np.int64)}, {"a": np.zeros(2, np.int64)}])
    assert d["a"].dtype == torch.int64 and d["a"].shape == (2, 2)
