"""The verified atomic commit (``resilience/commit.py``), its fault
injectors (``resilience/chaos.py``) and the checkpoint engines
(``runtime/checkpoint_engine/engines.py``) of the port, on the CPU: the
commit-protocol and checkpoint-engine cases of the JAX package's
``tests/unit/test_resilience.py``, run against the port's engine (a tiny
llama).  Where a JAX case goes through the ``resilience`` config block
(``keep_n``, ``io_retries``; the block comes with ROADMAP Queue 1 #16)
the same mechanism is driven through ``checkpoint/saving.save_checkpoint``
and ``io_retry`` directly, and the every-engine round trip through the
engines themselves (the JAX case uses the partitioned layout, #8).

Also the streamed writer: a stacked member written slice by slice is
byte for byte ``np.savez`` of the stacked arrays, and its CRCs are
``array_checksums``'.
"""

import json
import os
import time
import zipfile

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import saving
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.resilience import CorruptCheckpointError, chaos
from deepspeed_tpu_torch.resilience import metrics as res_metrics
from deepspeed_tpu_torch.resilience.commit import (MANIFEST, array_checksums, begin_commit,
                                                   checkpoint_commit, gc_tags, io_retry,
                                                   list_tags, manifest_meta, resolve_tag,
                                                   verify_tag)
from deepspeed_tpu_torch.runtime.checkpoint_engine.engines import (
    CheckpointEngine, CheckpointSaveError, DecoupledCheckpointEngine, FastCheckpointEngine,
    make_checkpoint_engine)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

torch.set_num_threads(2)


def _engine(checkpoint=None):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if checkpoint is not None:
        cfg["checkpoint"] = checkpoint
    engine, *_ = deepspeed_tpu_torch.initialize(model=llama_model("tiny", max_seq_len=32),
                                                config=cfg, device="cpu", seed=0)
    return engine


def _train(engine, steps, start=0):
    out = []
    for i in range(steps):
        ids = np.random.RandomState((start + i) % 3).randint(0, 256, (1, 2, 9))
        out.append(float(engine.train_batch(ids)))
    return out


def _params(engine):
    return {k: v.copy() for k, v in _flat(params_to_numpy(engine.get_params())).items()}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: v})
    return out


def _params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------ commit protocol
def test_commit_layout_and_verification(tmp_path):
    e = _engine()
    _train(e, 2)
    path = e.save_checkpoint(str(tmp_path))
    assert os.path.isdir(path) and path.endswith("global_step2")
    assert os.path.exists(os.path.join(path, MANIFEST))
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp.")]
    assert open(tmp_path / "latest").read().strip() == "global_step2"
    report = verify_tag(str(tmp_path), "global_step2")
    assert report["ok"] and report["verified"] and not report["problems"]
    man = chaos.read_manifest(str(tmp_path), "global_step2")
    assert man["meta"]["global_steps"] == 2
    assert man["meta"]["world"] == 1
    assert "data" in man["meta"]["mesh"]
    assert man["meta"]["array_crc32"]
    assert manifest_meta(str(tmp_path), "global_step2") == man["meta"]
    assert all("crc32" in info for info in man["files"].values())
    with np.load(os.path.join(path, saving.MODEL_FILE)) as z:
        assert array_checksums({k: z[k] for k in z.files}) == man["meta"]["array_crc32"]


def test_unfinalized_staging_is_invisible_and_gced(tmp_path):
    staging = begin_commit(str(tmp_path), "crashed")
    with open(os.path.join(staging, "model.bin"), "wb") as f:
        f.write(b"x" * 128)
    tag, report = resolve_tag(str(tmp_path))
    assert tag is None and not report["ok"]
    e = _engine()
    _train(e, 1)
    e.save_checkpoint(str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp.")]
    tag, _ = resolve_tag(str(tmp_path))
    assert tag == "global_step1"


def test_partial_staging_from_chaos_is_never_a_candidate(tmp_path):
    chaos.make_partial_staging(str(tmp_path), "t9")
    assert list_tags(str(tmp_path)) == []
    assert gc_tags(str(tmp_path)) == ["tmp.t9"]


def test_gc_keep_n(tmp_path):
    e = _engine()
    for _ in range(4):
        _train(e, 1)
        saving.save_checkpoint(e, str(tmp_path), keep_n=2)
    assert list_tags(str(tmp_path)) == ["global_step4", "global_step3"]
    assert open(tmp_path / "latest").read().strip() == "global_step4"


def test_bitflip_detected_counted_and_fallback(tmp_path):
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(str(tmp_path))
    good = _params(e1)
    _train(e1, 1, start=1)
    e1.save_checkpoint(str(tmp_path))
    chaos.bitflip_array(str(tmp_path), "global_step2", seed=3)
    before = res_metrics.corrupt_checkpoints_total().total()
    e2 = _engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step1")
    assert e2.global_steps == 1
    _params_equal(_params(e2), good)
    assert res_metrics.corrupt_checkpoints_total().total() == before + 1


def test_torn_manifest_falls_back(tmp_path):
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(str(tmp_path))
    _train(e1, 1, start=1)
    e1.save_checkpoint(str(tmp_path))
    chaos.tear_manifest(str(tmp_path), "global_step2")
    e2 = _engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and e2.global_steps == 1


def test_explicit_corrupt_tag_raises(tmp_path):
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(str(tmp_path))
    chaos.bitflip_array(str(tmp_path), "global_step1", seed=0)
    with pytest.raises(CorruptCheckpointError, match="global_step1"):
        _engine().load_checkpoint(str(tmp_path), tag="global_step1")


def test_stale_latest_pointer_falls_back(tmp_path):
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(str(tmp_path))
    chaos.corrupt_latest_pointer(str(tmp_path))
    before = res_metrics.corrupt_checkpoints_total().total()
    path, _ = _engine().load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1")
    assert res_metrics.corrupt_checkpoints_total().total() == before


def test_explicit_missing_tag_is_not_corruption(tmp_path):
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(str(tmp_path))
    before = res_metrics.corrupt_checkpoints_total().total()
    with pytest.raises(FileNotFoundError, match="no_such_tag"):
        _engine().load_checkpoint(str(tmp_path), tag="no_such_tag")
    assert res_metrics.corrupt_checkpoints_total().total() == before


def test_foreign_subdirs_survive_gc_and_resolution(tmp_path):
    logs = tmp_path / "tensorboard"
    logs.mkdir()
    (logs / "events.out").write_text("not a checkpoint")
    e = _engine()
    for _ in range(3):
        _train(e, 1)
        saving.save_checkpoint(e, str(tmp_path), keep_n=1)
    assert (logs / "events.out").exists()
    assert list_tags(str(tmp_path)) == ["global_step3"]
    chaos.corrupt_latest_pointer(str(tmp_path), target="tensorboard")
    tag, _ = resolve_tag(str(tmp_path))
    assert tag == "global_step3"


def test_manifest_entry_without_crc_is_reported_not_crash(tmp_path):
    e = _engine()
    _train(e, 1)
    e.save_checkpoint(str(tmp_path))
    man_path = tmp_path / "global_step1" / MANIFEST
    man = json.loads(man_path.read_text())
    next(iter(man["files"].values())).pop("crc32")
    man_path.write_text(json.dumps(man))
    report = verify_tag(str(tmp_path), "global_step1")
    assert not report["ok"] and report["problems"]


def test_legacy_checkpoint_without_manifest_loads_unverified(tmp_path):
    e1 = _engine()
    _train(e1, 1)
    e1.save_checkpoint(str(tmp_path))
    os.remove(tmp_path / "global_step1" / MANIFEST)
    report = verify_tag(str(tmp_path), "global_step1")
    assert report["ok"] and not report["verified"]
    e2 = _engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and e2.global_steps == 1
    _params_equal(_params(e2), _params(e1))


def test_unverified_load_checks_each_members_crc(tmp_path):
    """Without a manifest the reader checks the zip CRC of what it reads."""
    e1 = _engine()
    _train(e1, 1)
    path = e1.save_checkpoint(str(tmp_path))
    os.remove(os.path.join(path, MANIFEST))
    chaos.bitflip_array(str(tmp_path), "global_step1", seed=5)
    with pytest.raises(Exception, match="CRC|crc|checkpoint member|ends early"):
        _engine().load_checkpoint(str(tmp_path))


# --------------------------------------------------------- checkpoint engines
@pytest.mark.parametrize("ckpt_cfg", [{}, {"parallel_write_pipeline": True},
                                      {"async_save": True}, {"writer": "nebula"},
                                      {"writer": "datastates"}],
                         ids=["sync", "fast", "decoupled", "nebula", "datastates"])
def test_every_checkpoint_engine_kind_round_trips_the_state(tmp_path, ckpt_cfg):
    """The engine the config picks writes the training state's arrays
    inside a verified commit and reads them back bit-equal."""
    e1 = _engine(checkpoint=ckpt_cfg)
    _train(e1, 2)
    ce = make_checkpoint_engine(e1.config)
    want = {}
    for m in saving.state_members(e1, with_grad_acc=False):
        raw = np.concatenate([np.frombuffer(saving._bytes(saving._host_view(s)), np.uint8)
                              for s in m.slices])
        want[m.key] = raw.view(m.dtype).reshape(m.shape)
    with checkpoint_commit(str(tmp_path), "global_step2") as staging:
        ce.save(want, os.path.join(staging, "state"))
        assert ce.commit("global_step2") is True
    report = verify_tag(str(tmp_path), "global_step2")
    assert report["ok"] and report["verified"]
    got = ce.load(os.path.join(str(tmp_path), "global_step2", "state"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_checkpoint_writer_names_are_checked():
    with pytest.raises(ValueError, match="unknown checkpoint.writer"):
        make_checkpoint_engine(DeepSpeedConfig({"checkpoint": {"writer": "s3"}}))
    fast = make_checkpoint_engine(DeepSpeedConfig({"checkpoint": {
        "parallel_write_pipeline": True}, "aio": {"thread_count": 2}}))
    assert isinstance(fast, FastCheckpointEngine)


def test_fast_engine_zero_size_arrays_roundtrip(tmp_path):
    ce = FastCheckpointEngine(thread_count=2)
    arrays = {"empty1d": np.empty((0,), np.float32),
              "empty2d": np.empty((3, 0), np.int32),
              "scalar": np.float32(7.0).reshape(()),
              "normal": np.arange(12, dtype=np.float32).reshape(3, 4)}
    ce.save(arrays, str(tmp_path / "fast"))
    out = ce.load(str(tmp_path / "fast"))
    for k, v in arrays.items():
        assert out[k].shape == v.shape and out[k].dtype == v.dtype, k
        np.testing.assert_array_equal(out[k], v)
    with open(tmp_path / "fast" / "manifest.json") as f:
        man = json.load(f)
    assert man["empty1d"].get("empty") and "file" not in man["empty1d"]


def test_fast_engine_manifest_written_atomically(tmp_path):
    ce = FastCheckpointEngine(thread_count=2)
    ce.save({"a": np.ones(8, np.float32)}, str(tmp_path / "fast"))
    files = os.listdir(tmp_path / "fast")
    assert "manifest.json" in files
    assert not [f for f in files if ".tmp." in f], files


class _FailingInner(CheckpointEngine):
    def save(self, arrays, path):
        raise IOError(f"disk on fire while writing {path}")


class _RecordingInner(CheckpointEngine):
    def __init__(self):
        self.events = []

    def save(self, arrays, path):
        self.events.append(("start", path))
        time.sleep(0.1)
        self.events.append(("end", path))

    def load(self, path):
        return {}


def test_decoupled_failure_attributed_to_owning_save(tmp_path):
    ce = DecoupledCheckpointEngine(inner=_FailingInner())
    ce.save({"x": np.ones(4, np.float32)}, str(tmp_path / "first_ckpt"))
    with pytest.raises(CheckpointSaveError, match="first_ckpt") as ei:
        ce.save({"x": np.ones(4, np.float32)}, str(tmp_path / "second_ckpt"))
    assert ei.value.path == str(tmp_path / "first_ckpt")
    assert "second_ckpt" not in str(ei.value)
    assert ce.commit("after") is True


def test_decoupled_commit_reports_owning_tag(tmp_path):
    ce = DecoupledCheckpointEngine(inner=_FailingInner())
    ce.save({"x": np.ones(4, np.float32)}, str(tmp_path / "ck"))
    with pytest.raises(CheckpointSaveError, match="tag 'step7'"):
        ce.commit("step7")


def test_decoupled_one_in_flight_contract(tmp_path):
    inner = _RecordingInner()
    ce = DecoupledCheckpointEngine(inner=inner)
    ce.save({"x": np.ones(4, np.float32)}, str(tmp_path / "a"))
    ce.save({"x": np.ones(4, np.float32)}, str(tmp_path / "b"))
    ce.commit("final")
    assert inner.events == [("start", str(tmp_path / "a")), ("end", str(tmp_path / "a")),
                            ("start", str(tmp_path / "b")), ("end", str(tmp_path / "b"))]


# -------------------------------------------------------------------- io_retry
def test_io_retry_rides_out_flaky_fs(tmp_path):
    e = _engine()
    _train(e, 1)
    before = res_metrics.io_retries_total().total()
    chaos.install_io_fault(chaos.FlakyIO(fail_ops=2))
    try:
        path = io_retry(lambda: e.save_checkpoint(str(tmp_path)), retries=3,
                        base_delay_s=0.01, what="checkpoint save")
    finally:
        chaos.install_io_fault(None)
    assert os.path.isdir(path)
    assert verify_tag(str(tmp_path), "global_step1")["ok"]
    assert res_metrics.io_retries_total().total() == before + 2


def test_io_retry_gives_up_after_budget():
    calls = []

    def always_fails():
        calls.append(1)
        raise OSError("nope")

    with pytest.raises(OSError):
        io_retry(always_fails, retries=2, base_delay_s=0.0)
    assert len(calls) == 3


# --------------------------------------------------------- the streamed writer
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int32, np.bool_])
def test_streamed_members_are_np_savez_bytes(dtype, tmp_path, monkeypatch):
    monkeypatch.setattr(zipfile.time, "time", lambda: 1.7e9)  # both files' zip dates
    rng = np.random.RandomState(0)
    layers = [(rng.randn(5, 7) * 100).astype(dtype) for _ in range(3)]
    arrays = {"stacked": np.stack(layers), "scalar": np.asarray(3, np.int32),
              "empty": np.zeros((0, 4), np.float32), "flat": layers[0].reshape(-1)}
    np.savez(tmp_path / "ref.npz", **arrays)
    w = saving.NpzWriter(str(tmp_path / "streamed.npz"))
    crcs = {"stacked": w.add("stacked", dtype, (3, 5, 7), iter(layers)),
            "scalar": w.add("scalar", np.int32, (), [arrays["scalar"]]),
            "empty": w.add("empty", np.float32, (0, 4), [arrays["empty"]]),
            "flat": w.add("flat", dtype, (35,), [layers[0]])}
    w.close()
    assert (tmp_path / "streamed.npz").read_bytes() == (tmp_path / "ref.npz").read_bytes()
    assert crcs == array_checksums(arrays)
    r = saving.NpzReader(str(tmp_path / "ref.npz"))
    try:
        out = [np.empty((5, 7), dtype) for _ in range(3)]
        r.read_into("stacked", [memoryview(o.reshape(-1)).cast("B") for o in out])
        assert all(np.array_equal(a, b) for a, b in zip(out, layers))
        assert r.read("scalar") == 3 and r.read("empty").shape == (0, 4)
    finally:
        r.close()
    with pytest.raises(ValueError, match="holds"):
        saving.NpzWriter(str(tmp_path / "bad.npz")).add("x", dtype, (4, 5, 7), iter(layers))


def test_file_crc_in_parallel_parts_is_zlibs(tmp_path, monkeypatch):
    """A file past ``_CRC_PART`` is checksummed in parts on threads and the
    parts' CRCs combined: zlib's CRC of the whole file, as the manifest
    records it; ``crc32_combine`` is zlib's."""
    import zlib

    from deepspeed_tpu_torch.resilience import commit

    rng = np.random.RandomState(0)
    data = rng.bytes(3 * 4096 + 123)
    path = tmp_path / "blob"
    path.write_bytes(data)
    monkeypatch.setattr(commit, "_CRC_PART", 4096)
    assert commit._crc32_file(str(path)) == zlib.crc32(data)
    for cut in (0, 1, 4096, len(data)):
        a, b = data[:cut], data[cut:]
        assert commit.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(data)
