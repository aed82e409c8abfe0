"""Continuous-batching serving over a paged KV pool, with the asyncio
front door."""
from repro_torch.serving.engine import (SchedulerConfig, ServeRequest,
                                  ServingEngine, latency_percentiles)
from repro_torch.serving.server import AsyncServingServer, RequestRejected
from repro_torch.serving.trace import (poisson_requests, replay_open_loop,
                                 tenant_poisson_requests)

__all__ = ["SchedulerConfig", "ServeRequest", "ServingEngine",
           "latency_percentiles", "AsyncServingServer", "RequestRejected",
           "poisson_requests", "tenant_poisson_requests",
           "replay_open_loop"]
