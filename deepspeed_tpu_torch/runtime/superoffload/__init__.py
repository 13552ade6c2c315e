from .superoffload import SuperOffloadOptimizer  # noqa: F401
