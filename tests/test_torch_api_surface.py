"""The public names the port leaves out, pinned.

For every Python file of the JAX package (outside ``ops/pallas/``, whose
kernels the port has as CUDA sources) with a file at the same path in the
port, the JAX file's public top-level names and public methods of its
public classes (an AST scan) are looked up on the port's module: a name
the port lacks must be in ``OMITTED`` with its reason, and every entry of
``OMITTED`` must still be missing.  A new JAX name the port lacks fails by
name here.  Exact: names only."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "deepspeed_tpu", ROOT / "deepspeed_tpu_torch"

Q1 = "ROADMAP Queue 1"
OMITTED = {
    "__init__.py": {"init_distributed": f"{Q1} #9 (communication)",
                    "tp_model_init": f"{Q1} #13b (tensor-parallel inference)"},
    "accelerator/__init__.py": {
        "TPUAccelerator": "renamed: CUDAAccelerator is the card's accelerator"},
    "inference/engine.py": {
        "InferenceConfig.jnp_dtype": "no torch counterpart: torch_dtype is the port's"},
    "inference/v2/engine_v2.py": {
        "RaggedInferenceConfig.jnp_dtype": "no torch counterpart: torch_dtype is the port's"},
    "inference/v2/model_runner.py": {
        "pad_pages_pow2": "no torch counterpart: eager torch compiles no shapes"},
    "models/transformer.py": {"transformer_partition_rules": f"{Q1} #8 (ZeRO across ranks)"},
    "profiling/flops_profiler.py": {
        "cost_analysis_of": "no torch counterpart: XLA's cost analysis"},
    "runtime/config.py": {"MeshConfig": f"{Q1} #8 (ZeRO across ranks)",
                          "PipelineConfig": f"{Q1} #12 (pipeline)",
                          "CommsLoggerConfig": f"{Q1} #9 (communication)",
                          "GradientCompressionConfig": f"{Q1} #9 (communication)"},
    "runtime/engine.py": {"DeepSpeedTPUEngine.compile": "ROADMAP Queue 2 item 11"},
    "runtime/fp16/onebit.py": {"OneBitState": f"{Q1} #9 (the compressed all-reduce)"},
    "runtime/module.py": {"ModelSpec.partition_rules": f"{Q1} #8 (ZeRO across ranks)",
                          "ModelSpec.from_flax": "no torch counterpart: flax modules"},
    "runtime/optimizers.py": {"pallas_fused_adam": "renamed: optimizers.fused_adam"},
    "telemetry/compile_sentinel.py": {
        "install_compile_listener": "no torch counterpart: jax.monitoring's listener"},
}


def public_names(path: Path):
    """Public top-level functions and classes, and each public class's
    public methods as ``Class.method`` (not for a class the port lacks
    whole)."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.append((node.name, [m.name for m in node.body
                                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                    and not m.name.startswith("_")]))
    return out


def ported_files():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG)
        if rel.parts[:2] != ("ops", "pallas") and (PORT_PKG / rel).exists():
            yield rel.as_posix()


def missing_names(rel: str):
    mod_name = "deepspeed_tpu_torch." + rel[:-3].replace("/", ".")
    mod = importlib.import_module(mod_name.removesuffix(".__init__"))
    missing = []
    for entry in public_names(JAX_PKG / rel):
        if isinstance(entry, str):
            if not hasattr(mod, entry):
                missing.append(entry)
            continue
        cls, methods = entry
        if not hasattr(mod, cls):
            missing.append(cls)
            continue
        missing += [f"{cls}.{m}" for m in methods if not hasattr(getattr(mod, cls), m)]
    return missing


@pytest.mark.parametrize("rel", list(ported_files()))
def test_missing_public_names_are_the_pinned_ones(rel):
    assert sorted(missing_names(rel)) == sorted(OMITTED.get(rel, {}))


def test_every_omission_has_a_reason_and_a_file():
    files = set(ported_files())
    for rel, names in OMITTED.items():
        assert rel in files, rel
        assert all(reason.strip() for reason in names.values()), rel


def test_the_single_card_names_are_ported():
    """The names ROADMAP Queue 1 #21 and #22 listed are all on the port."""
    pinned = {n for names in OMITTED.values() for n in names}
    for name in ("no_sync", "set_train_batch_size", "set_train_micro_batch_size",
                 "stack_microbatches", "start_profiler_trace", "stop_profiler_trace"):
        assert f"DeepSpeedTPUEngine.{name}" not in pinned
    for name in ("add_config_arguments", "log_dist", "get_accelerator", "set_accelerator",
                 "Accelerator", "OpBuilder", "get_builder", "PinnedBufferPool",
                 "default_aio_handle", "nonfinite_count", "get_scalar_param"):
        assert name not in pinned
