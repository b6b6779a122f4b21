"""Serving: Scheduler (policy, copied from the JAX package) ->
ModelRunner (torch execution) -> Engine (facade, with a double-buffered
`step_pipelined()` loop) -> AsyncEngine (asyncio submission, token
streaming, SLO-aware admission)."""
from repro_torch.serve.async_engine import (AsyncEngine,  # noqa: F401
                                            AsyncRequestHandle, SLORejected)
from repro_torch.serve.engine import (Engine, FinishedRequest, Request,  # noqa: F401
                                      SamplingParams, ServeConfig)
from repro_torch.serve.runner import ModelRunner  # noqa: F401
from repro_torch.serve.telemetry import RequestMetrics, Telemetry  # noqa: F401
