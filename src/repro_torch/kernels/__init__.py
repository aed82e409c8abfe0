"""The port's kernels: each a CUDA source under ``csrc/`` for Hopper, a
wrapper module here that launches it on CUDA tensors, and a plain
PyTorch version in :mod:`repro_torch.kernels.ref` that the wrapper takes
on CPU tensors.  Each wrapper function counts its kernel launches in its
``launches`` attribute, on the host where it launches; a CUDA graph's
replay adds the launches its capture counted (:func:`add_launches`)."""


def wrappers() -> tuple:
    """The kernel wrapper functions: the paged path's three, then the
    contiguous path's, then the RG-LRU's fused entry (the model's call
    of the ``rglru_scan`` kernel source), then the training path's
    backward kernels: flash attention's, the ``wkv6`` recurrence's, the
    RG-LRU's (its fused entry's) and the expert FFN's."""
    from repro_torch.kernels import (decode_attention as da,
                                     flash_attention as fa,
                                     flash_attention_bwd as fb,
                                     moe_ffn as mf,
                                     paged_decode_attention as pd,
                                     rglru_scan as rg, wkv6 as wk)
    return (pd.paged_decode_attention, fa.flash_attention, mf.moe_ffn,
            da.decode_attention, rg.rglru_scan, wk.wkv6,
            rg.rglru_gated_scan, fb.flash_attention_bwd, wk.wkv6_bwd,
            rg.rglru_gated_scan_bwd, mf.moe_ffn_bwd)


def launch_counts() -> dict:
    """{wrapper name: launches}, {"<name> <route>": launches} for each
    route of a wrapper that picks between kernels (``route_launches``),
    and {"<name> q_offset": launches} of the flash kernels' launches with
    a nonzero query offset (``offset_launches``: context parallelism)."""
    counts = {}
    for fn in wrappers():
        counts[fn.__name__] = fn.launches
        for route, n in getattr(fn, "route_launches", {}).items():
            counts[f"{fn.__name__} {route}"] = n
        if hasattr(fn, "offset_launches"):
            counts[f"{fn.__name__} q_offset"] = fn.offset_launches
    return counts


def add_launches(counts: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (keys of :func:`launch_counts`) to
    the wrappers' counters."""
    for fn in wrappers():
        name = fn.__name__
        fn.launches += sign * counts.get(name, 0)
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] += sign * counts.get(f"{name} {route}",
                                                          0)
        if hasattr(fn, "offset_launches"):
            fn.offset_launches += sign * counts.get(f"{name} q_offset", 0)


def reset_launches() -> None:
    for fn in wrappers():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0
        if hasattr(fn, "offset_launches"):
            fn.offset_launches = 0
