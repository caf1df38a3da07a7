"""Products at a stated precision: "f32" (TF32 off) or "tf32".

"tf32" is the control's precision: each operand rounded to TF32's 10-bit
mantissa (round to nearest), products accumulated in float32, which is what
the tensor cores do with TF32 on. Rounding the operands here, rather than
switching `allow_tf32`, gives the same numbers on the card and on a CPU.
"""
from __future__ import annotations

import torch


def set_f32() -> None:
    """Full float32 products on the card, for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to the nearest TF32 value (8-bit exponent, 10-bit
    mantissa), kept in an f32 tensor."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "tf32":
        return tf32_round(x)
    raise ValueError(f"unknown precision {prec!r}")


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b with both operands at `prec`."""
    return operand(a, prec) @ operand(b, prec)


def rowdot(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """Σ_last a·b, broadcast, with both operands at `prec`."""
    return (operand(a, prec) * operand(b, prec)).sum(-1)
