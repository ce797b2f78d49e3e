"""Training data: stateless, step-indexed token batches (``pipeline.py``)."""
