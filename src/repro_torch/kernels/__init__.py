"""The port's kernels: each a CUDA source under ``csrc/`` for Hopper, a
wrapper module here that launches it on CUDA tensors, and a plain
PyTorch version in :mod:`repro_torch.kernels.ref` that the wrapper takes
on CPU tensors.  Each wrapper function counts its kernel launches in its
``launches`` attribute."""


def wrappers() -> tuple:
    """The six kernel wrapper functions: the paged path's three, then the
    contiguous path's."""
    from repro_torch.kernels import (decode_attention as da,
                                     flash_attention as fa, moe_ffn as mf,
                                     paged_decode_attention as pd,
                                     rglru_scan as rg, wkv6 as wk)
    return (pd.paged_decode_attention, fa.flash_attention, mf.moe_ffn,
            da.decode_attention, rg.rglru_scan, wk.wkv6)


def reset_launches() -> None:
    for fn in wrappers():
        fn.launches = 0
