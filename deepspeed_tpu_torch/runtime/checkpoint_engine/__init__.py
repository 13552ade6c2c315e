"""Checkpoint engines (``engines.py``)."""
