"""Fault-tolerance runtime: watchdog, preemption, restarts, chaos
(``fault.py``)."""
