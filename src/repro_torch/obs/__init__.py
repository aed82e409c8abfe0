"""Observability: pipeline tracing + metrics for the serving stack (the
port's copy of ``repro/obs``, host-side Python with no JAX).

One facade object (:class:`Obs`) bundles the two backbones every layer
shares:

* ``obs.tracer`` — span tracer exporting Chrome trace-event JSON
  (:mod:`repro_torch.obs.trace`; device spans timed by marks on a card),
  plus bubble accounting that derives the paper's GPU-utilization metric
  from the recorded spans.
* ``obs.metrics`` — labeled Counter/Gauge/Histogram registry with JSON
  snapshot and Prometheus text exposition (:mod:`repro_torch.obs.metrics`).

Components take ``obs=None`` and fall back to :data:`NULL_OBS`, whose
tracer and registry are shared no-op singletons — the disabled mode is
allocation-free and adds nothing to the engine loop (tested in
``tests/test_torch_obs.py``).  Build a live one with :func:`make_obs`.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.metrics import (NULL_REGISTRY, NullRegistry,  # noqa: F401
                               Registry, acceptance_buckets)
from repro_torch.obs.request_trace import (NULL_REQUEST_TRACKER,  # noqa: F401
                                     NullRequestTracker, RequestTracker,
                                     timelines_summary)
from repro_torch.obs.slo import (SLO, FlightRecorder, SLOMonitor,  # noqa: F401
                           as_slos)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,  # noqa: F401
                             bubble_report)


@dataclass(frozen=True)
class Obs:
    """Tracer + metrics registry bundle passed down the serving stack."""
    tracer: Tracer | NullTracer
    metrics: Registry | NullRegistry

    @property
    def enabled(self) -> bool:
        """True when either backbone records anything."""
        return self.tracer.enabled or self.metrics.enabled


NULL_OBS = Obs(NULL_TRACER, NULL_REGISTRY)


def make_obs(trace: bool = False, metrics: bool = True,
             annotations: bool = False, virtual_clock=None,
             device=None) -> Obs:
    """Build an :class:`Obs`; disabled backbones are the null singletons.

    ``annotations`` additionally enters ``torch.profiler.record_function``
    per span so phase names appear as ranges in ``torch.profiler`` traces;
    ``device``: where the traced work runs.  On a CUDA device the tracer
    times device spans by marks (:class:`repro_torch.kernels.obs_mark.
    MarkRing`, built at the first mark); elsewhere on the host.
    """
    if not (trace or metrics):
        return NULL_OBS
    tr = NULL_TRACER
    if trace:
        marks = None
        if device is not None and str(device).startswith("cuda"):
            from repro_torch.kernels.obs_mark import MarkRing
            marks = MarkRing(device)
        tr = Tracer(annotations=annotations, virtual_clock=virtual_clock,
                    marks=marks)
    reg = Registry() if metrics else NULL_REGISTRY
    return Obs(tr, reg)
