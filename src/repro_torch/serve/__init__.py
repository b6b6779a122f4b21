"""Serving: Scheduler (policy, copied from the JAX package) ->
ModelRunner (torch execution) -> Engine (facade)."""
from repro_torch.serve.engine import (Engine, FinishedRequest, Request,  # noqa: F401
                                      SamplingParams, ServeConfig)
from repro_torch.serve.runner import ModelRunner  # noqa: F401
from repro_torch.serve.telemetry import RequestMetrics, Telemetry  # noqa: F401
