"""Fault-tolerance runtime: watchdog, preemption, restarts, chaos
(``fault.py``); GPipe pipeline parallelism (``pipeline_parallel.py``);
one-process SPMD over a local mesh (``spmd.py``)."""
