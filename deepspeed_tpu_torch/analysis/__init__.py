"""Static analysis of the port's own tree (the counterpart of
``deepspeed_tpu/analysis``), both pure AST and run in tier-1 on the CPU:

* :mod:`.lint` — the hazard linter (host syncs on the step paths, wall
  clock and unseeded randomness in deterministic paths, swallowed
  exceptions, mutable defaults, set order in sharding code, the overlap
  and SLO-exemplar contracts): ``python -m deepspeed_tpu_torch.analysis.lint``.
* :mod:`.metric_lint` — the metric- and span-name lint against
  ``docs/OBSERVABILITY.md``: ``python -m deepspeed_tpu_torch.analysis.metric_lint``.

The JAX package's third pillar, HLO contracts (``contracts.py``), has its
port counterpart still to come (ROADMAP Queue 1 #18).
"""

from __future__ import annotations

_SUBMODULES = ("lint", "metric_lint")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
