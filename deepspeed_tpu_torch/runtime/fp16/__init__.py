"""1-bit optimizers (``onebit.py``)."""
