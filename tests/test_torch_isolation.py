"""The port stands alone: no file of ``deepspeed_tpu_torch/`` nor
``chip_smoke.py`` imports JAX or any module of the JAX package, nor
``ml_dtypes``, ``transformers`` or ``safetensors`` (none is on the card's
machine), and the entry points default to CUDA."""

import ast
import inspect
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.linear.optimized_linear import init_lora_linear
from deepspeed_tpu_torch.inference.v2.ragged import KVBlockConfig, PagedKVCache
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.models.transformer import alibi_slopes, init_kv_cache
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine
from deepspeed_tpu_torch.runtime.module import ModelSpec

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(Path(deepspeed_tpu_torch.__file__).parent.rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu", "ml_dtypes", "transformers", "safetensors")


def _forbidden(module: str) -> bool:
    """Exact module-name match: ``deepspeed_tpu_torch`` is not
    ``deepspeed_tpu``."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") in
              ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)
        elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                and node.value.id in ("jax", "jnp"):
            yield node.lineno, node.value.id


def test_rule_matches_exact_module_names():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("deepspeed_tpu")
    assert _forbidden("deepspeed_tpu.ops.pallas")
    assert not _forbidden("deepspeed_tpu_torch") and not _forbidden("deepspeed_tpu_torch.ops")
    assert not _forbidden("jaxtyping_free")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert path.exists(), path
    bad = [(line, m) for line, m in _imports(path) if _forbidden(m) or m == "jnp"]
    assert not bad, f"{path.relative_to(ROOT)} reaches JAX: {bad}"


def test_relative_imports_stay_inside_the_port():
    """``from ... import`` never climbs out of ``deepspeed_tpu_torch``."""
    pkg = Path(deepspeed_tpu_torch.__file__).parent
    for path in pkg.rglob("*.py"):
        depth = len(path.relative_to(pkg).parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level - 1 <= depth, (path, node.lineno)


def test_entry_points_default_to_cuda():
    for fn in (InferenceEngineV2, ModelSpec.init_params, resolve_device,
               params_from_numpy, PagedKVCache.init, alibi_slopes,
               deepspeed_tpu_torch.initialize, DeepSpeedTPUEngine,
               deepspeed_tpu_torch.init_inference, InferenceEngine, init_kv_cache,
               init_lora_linear):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()  # this machine has no CUDA: the default is not the CPU


def test_public_builders_raise_without_cuda():
    """Parameters, pools and ALiBi slopes built without a device do not
    land on the CPU (where the programs would take the plain attention)."""
    model = llama_model("tiny")
    tree = params_to_numpy(model.init_params(torch.Generator().manual_seed(0), "cpu"))
    block = KVBlockConfig(page_size=4, num_pages=4, max_seqs=1, max_pages_per_seq=4)
    cfg = model.config
    for build in (lambda: params_from_numpy(tree, cfg),
                  lambda: PagedKVCache.init(cfg.n_layers, cfg.kv_heads, cfg.head_dim, block),
                  lambda: alibi_slopes(cfg.n_heads),
                  lambda: init_kv_cache(cfg, 1, 8),
                  lambda: deepspeed_tpu_torch.init_inference(model, params=tree),
                  lambda: init_lora_linear(torch.Generator(), 4, 4, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_training_entry_point_raises_without_cuda():
    """``initialize`` with no device trains on CUDA, never silently on the
    CPU; ``device="cpu"`` is the explicit opt-in."""
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=llama_model("tiny"), config={})
    engine, *_ = deepspeed_tpu_torch.initialize(model=llama_model("tiny"), config={},
                                                device="cpu")
    assert engine.device.type == "cpu"
