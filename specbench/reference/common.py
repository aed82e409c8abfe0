"""Shared pieces of the plain reference."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def full_precision():
    """float32 products in float32: TF32 off for the duration."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (f32) rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum maps to 448), back in f32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x: torch.Tensor, w: torch.Tensor, quant: str | None):
    """x (..., in) f32 times w (in, out), in f32 or through fp8."""
    w = w.float()
    if quant == "fp8":
        return fake_fp8(x, -1) @ fake_fp8(w, 0)
    if quant == "bf16":
        return x.bfloat16().float() @ w.bfloat16().float()
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def head_logits(params: dict, hidden: torch.Tensor, quant: str | None):
    """Final norm and the output head over ``hidden`` (n, D)."""
    h = rms_norm(hidden, params["final_norm"]["scale"])
    return linear(h, params["embed"]["head"], quant)
