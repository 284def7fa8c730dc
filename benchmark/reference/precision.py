"""The precisions a reference computes in: float32, and the controls'
lower ones.  TF32 is float32 with its operands rounded to 10 mantissa
bits before each product (round to nearest even), as the card's TF32
mode rounds them; written out so that it reads the same on every device."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``: ``"float32"``, ``"tf32"`` or
    ``"bfloat16"``; the result in float32."""
    if precision == "tf32":
        return tf32(a.float()) @ tf32(b.float())
    if precision == "bfloat16":
        return (a.bfloat16() @ b.bfloat16()).float()
    return a.float() @ b.float()
