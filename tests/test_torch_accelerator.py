"""The port's accelerator (``deepspeed_tpu_torch/accelerator``) against the
JAX package's: ``tests/unit/test_accelerator.py``'s six tests on the
``CPUAccelerator``, detection (``DS_ACCELERATOR`` first, the CPU without a
card), the memory keys and the op-builder names.  Names and keys are
compared exactly; no numbers cross the packages."""

import ctypes

import pytest
import torch

from deepspeed_tpu import accelerator as jacc
from deepspeed_tpu.ops import op_builder as jbuild
from deepspeed_tpu_torch import accelerator as tacc
from deepspeed_tpu_torch.ops import op_builder as tbuild

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_accelerator(monkeypatch):
    """Every test detects anew, and leaves no choice behind."""
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    tacc.set_accelerator(None)
    yield
    tacc.set_accelerator(None)


def test_detection_cpu_without_a_card():
    acc = tacc.get_accelerator()
    assert isinstance(acc, tacc.CPUAccelerator)
    assert acc is tacc.get_accelerator()  # cached
    assert acc.device_count() == 1 and acc.is_available()
    assert acc.device_name() == "cpu"
    assert acc.device_name(3) == "cpu:3"


def test_ds_accelerator_env_comes_first(monkeypatch):
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    assert isinstance(tacc.get_accelerator(), tacc.CPUAccelerator)
    tacc.set_accelerator(None)
    monkeypatch.setenv("DS_ACCELERATOR", "cuda")
    assert isinstance(tacc.get_accelerator(), tacc.CUDAAccelerator)
    tacc.set_accelerator(None)
    monkeypatch.setenv("DS_ACCELERATOR", "tpu")
    with pytest.raises(ValueError, match="DS_ACCELERATOR"):
        tacc.get_accelerator()


def test_set_accelerator_replaces_the_choice():
    cuda = tacc.CUDAAccelerator()
    tacc.set_accelerator(cuda)
    assert tacc.get_accelerator() is cuda
    assert cuda.communication_backend_name() == "nccl"
    assert cuda.visible_devices_envs() == ["CUDA_VISIBLE_DEVICES"]


def test_stream_event_shims():
    acc = tacc.get_accelerator()
    with acc.stream(acc.Stream()):
        pass
    ev = acc.Event()
    ev.record()
    ev.synchronize()
    assert ev.elapsed_time(acc.Event()) == 0.0
    acc.current_stream().wait_stream(acc.default_stream())
    acc.synchronize()


def test_dtype_and_comm_surface():
    acc = tacc.get_accelerator()
    assert acc.is_bf16_supported() and acc.is_fp16_supported()
    assert torch.bfloat16 in acc.supported_dtypes()
    assert not acc.is_fp8_supported()
    assert acc.communication_backend_name() == "gloo"
    # the host has no graph capture (the JAX CPU accelerator says True: jit)
    assert acc.device_supports_graphs() is False
    assert acc.communication_backend_version() == torch.__version__


def test_rng_and_memory():
    acc = tacc.get_accelerator()
    state = torch.get_rng_state()
    try:
        acc.manual_seed(1234)
        assert acc.initial_seed() == 1234
        gen = acc.default_generator()
        assert isinstance(gen, torch.Generator) and gen.initial_seed() == 1234
        a = torch.randn(64)
        acc.manual_seed(1234)
        assert torch.equal(a, torch.randn(64))
    finally:
        torch.set_rng_state(state)
    assert acc.memory_allocated() >= 0
    assert acc.max_memory_allocated() > 0 and acc.memory_allocated() > 0
    assert acc.total_memory() >= acc.available_memory() >= 0


def test_memory_stats_keys_are_the_jax_cpu_accelerators():
    want = jacc.CPUAccelerator().memory_stats()
    got = tacc.get_accelerator().memory_stats()
    assert set(got) == set(want) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert got["bytes_limit"] == want["bytes_limit"]
    assert tacc.get_accelerator().aggregate_memory_stats().keys() == got.keys()


def test_op_builder_dispatch():
    acc = tacc.get_accelerator()
    b = acc.create_op_builder("CPUAdamBuilder")
    assert isinstance(b, tbuild.CPUAdamBuilder) and b.name == "cpu_adam"
    assert isinstance(b.load(), ctypes.CDLL) and b.is_compatible()
    assert acc.get_op_builder("AsyncIOBuilder") is tbuild.AsyncIOBuilder


def test_op_builder_names_are_the_jax_packages():
    assert set(tbuild.BUILDERS) == set(jbuild.BUILDERS)
    for name, cls in jbuild.BUILDERS.items():
        assert tbuild.get_builder(name).name == cls.name
        assert type(tbuild.get_builder(cls.name)) is tbuild.BUILDERS[name]
    with pytest.raises(KeyError):
        jbuild.get_builder("NoSuchBuilder")
    with pytest.raises(KeyError):
        tbuild.get_builder("NoSuchBuilder")
    assert tbuild.HostOpBuilder is tbuild.OpBuilder


def test_cuda_accelerator_props_without_a_card():
    """The JAX test's TPU accelerator counterpart: the card's accelerator
    answers its static surface without a card present."""
    cuda = tacc.CUDAAccelerator()
    assert cuda.communication_backend_name() == "nccl"
    assert cuda.device_name() == "cuda" and cuda.device_name(1) == "cuda:1"
    assert cuda.device_supports_graphs()
    assert jacc.TPUAccelerator().communication_backend_name() == "xla:ici"


def test_the_accelerators_have_every_method_of_the_jax_ones():
    for name in dir(jacc.Accelerator):
        if not name.startswith("_"):
            assert hasattr(tacc.Accelerator, name), name
    assert hasattr(tacc.CUDAAccelerator, "device_kind")
