"""Placement plans (``sharding.py``) and the first-principles roofline
model (``analytic.py``)."""
