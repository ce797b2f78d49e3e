"""Optimizers of the training path: AdamW with int8 moments and error-
feedback gradient compression (``adamw.py``)."""
