"""Fused multiply-add with one rounding, on any device.

XLA's CPU backend contracts `a * b + c` into a fused multiply-add, so the
JAX package's float32 results round once where two separate PyTorch ops
round twice. `fma` forms the product exactly in float64 (24-bit by 24-bit
mantissas fit in 53 bits), adds in float64 and rounds to float32: the same
value as a hardware FMA except where the float64 sum itself had to round
onto a float32 tie, which takes a sum needing more than 53 bits. The port
uses it where the reference's expression is contracted, so that it is
bit-exact against the JAX package on the CPU, and the card and the CPU give
the same values.
"""
from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """a * b + c, rounded once to float32."""
    a, b, c = (torch.as_tensor(t).double() for t in (a, b, c))
    return (a * b + c).float()
