"""The port's kernels: each a CUDA source under ``csrc/`` for Hopper, a
wrapper module here that launches it on CUDA tensors, and a plain
PyTorch version in :mod:`repro_torch.kernels.ref` that the wrapper takes
on CPU tensors.  Each wrapper function counts its kernel launches in its
``launches`` attribute."""


def wrappers() -> tuple:
    """The three kernel wrapper functions, in path order."""
    from repro_torch.kernels import (flash_attention as fa, moe_ffn as mf,
                                     paged_decode_attention as pd)
    return (pd.paged_decode_attention, fa.flash_attention, mf.moe_ffn)


def reset_launches() -> None:
    for fn in wrappers():
        fn.launches = 0
