"""Atomic, checksummed, keep-last-k checkpoints (``manager.py``)."""
