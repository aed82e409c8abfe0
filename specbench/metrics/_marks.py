"""Shared by the readers of the program's device marks
(``src/repro_torch/csrc/obs_mark.cu``): one-thread kernels named
``obs_mark_<kind>`` that the traced program puts on the stream at the
boundaries of its round, found here on the profiler's device timeline of
the traced slice."""


def _kind(name: str) -> str | None:
    base = name.split("(")[0]
    return base[len("obs_mark_"):] if base.startswith("obs_mark_") else None


def mean_between_ms(trace, begin: str, end: str):
    """Mean ms from the start of each ``obs_mark_<begin>`` kernel to the
    start of the next ``obs_mark_<end>``, over the slice's complete pairs
    (a pair the slice's edge cuts is left out); None where there is
    none."""
    if trace is None:
        return None
    spans, t_open = [], None
    for name, t0, _ in trace["device"]:
        kind = _kind(name)
        if kind == begin:
            t_open = t0
        elif kind == end and t_open is not None:
            spans.append(t0 - t_open)
            t_open = None
    return sum(spans) / len(spans) / 1e3 if spans else None
