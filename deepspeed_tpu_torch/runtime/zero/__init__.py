"""ZeRO's public surface at one rank: the counterpart of
``deepspeed_tpu/runtime/zero/__init__.py``.

``Init`` and ``GatheredParameters`` exist so reference-style code runs
unchanged; on one rank partitioning is the identity, so ``Init`` records
its arguments and does nothing, and ``GatheredParameters`` yields what it
is given.  ``ZeroShardingPlan`` (partitioning across ranks) waits for
ROADMAP Queue 1 #8.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

from .offload import HostOffloadedOptimizer  # noqa: F401


class Init:
    """``with zero.Init(): model = build()``: a no-op context that keeps the
    config it was given (``self.config``) for inspection."""

    def __init__(self, module: Any = None, data_parallel_group: Any = None,
                 mem_efficient_linear: bool = True, remote_device: str = None,
                 pin_memory: bool = False, config_dict_or_path: Any = None, **kwargs):
        self.config = dict(kwargs, remote_device=remote_device, pin_memory=pin_memory,
                           config=config_dict_or_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def GatheredParameters(params: Any, modifier_rank: Optional[int] = 0, fwd_module: Any = None,
                       enabled: bool = True):
    """Yield the parameters whole: at one rank they are never partitioned,
    so this is ``params`` itself (edits inside the context are edits of the
    live tensors)."""
    yield params
