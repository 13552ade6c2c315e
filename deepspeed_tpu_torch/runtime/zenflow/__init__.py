from .zenflow import ZenFlowConfig, ZenFlowOptimizer  # noqa: F401
