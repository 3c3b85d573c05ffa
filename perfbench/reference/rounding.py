"""The rounding every plain reference keeps: each product that the
original fuses into a sum is one rounding (the product of two float32
values in float64 is exact, then one add and one cast), and a division by a
constant of the model is a multiplication by that constant's float32
reciprocal. Plain PyTorch; imports nothing of the program."""
from __future__ import annotations

import numpy as np
import torch


def fused(a, b, c, dtype):
    """``a * b + c`` rounded once into ``dtype``."""
    return torch.addcmul(c, a.double(), b).to(dtype)


def fused_neg(a, b, c, dtype):
    """``c - a * b`` rounded once into ``dtype``."""
    return torch.addcmul(c, a.double(), b, value=-1).to(dtype)


def reciprocal(c: float) -> float:
    return float(np.float32(1) / np.float32(c))
