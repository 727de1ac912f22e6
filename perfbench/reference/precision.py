"""Products in a chosen precision: the reference's float32 and the two
lower precisions its controls run in.

* ``"f32"``: float32 products with TF32 off.
* ``"tf32"``: both operands rounded to TF32's 10 mantissa bits (to nearest,
  ties to even), then multiplied in float32: what a TF32 tensor core
  computes, and the same on the CPU.
* ``"fp8"``: both operands scaled per tensor to e4m3's largest value (448),
  rounded to float8 e4m3, scaled back; float32 accumulation.

Gradients pass through the rounding unchanged (the straight-through rule),
so a control differs from the reference in its forward products only.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as the products of ``precision`` see it, float32, with a
    straight-through gradient."""
    x = x.to(torch.float32)
    if precision == "f32":
        return x
    q = _round_tf32(x.detach()) if precision == "tf32" else _round_fp8(x.detach())
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return rounded(a, precision) @ rounded(b, precision)


def no_tf32():
    """Turn TF32 off for float32 products (PyTorch's default; stated
    here so that the reference does not depend on it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
