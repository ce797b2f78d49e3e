"""Fault-tolerant continuous-batching fractal-simulation serving.

Public surface::

    from repro_torch.serving import (FractalService, ServiceConfig,
                                     SimRequest, SimResult, AdmissionError)
    from repro_torch.runtime.fault import Fault, FaultInjector  # chaos

``FractalService()`` steps its batches on the card through a
``BatchedRunner()``; pass ``runner=BatchedRunner(device="cpu")`` for the
CPU.
"""
from repro_torch.serving.service import FractalService  # noqa: F401
from repro_torch.serving.types import (  # noqa: F401
    AdmissionError, CircuitBreaker, ServiceConfig, SimRequest, SimResult)
