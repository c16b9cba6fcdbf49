"""uint32 arithmetic on int32 tensors.

Hashes are kept as int32 bit patterns (torch's uint32 has partial op
coverage): shifts right are logical, compares are unsigned by the sign-bias
trick, and multiplies wrap mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.pyref import SEED32, SEED32C

BIG = 0x7FFFFFFF
_SIGN = -0x80000000


def i32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor, as int32 bit patterns."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a constant 0 <= s < 32."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def rol32(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 bit patterns left by a constant amount."""
    r %= 32
    if r == 0:
        return x
    return (x << r) | lshr(x, 32 - r)


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b on int32 bit patterns (sign-bias trick)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(ult(a, b), a, b)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for a uint32 constant c (exact through int64)."""
    return to_i32(x.to(torch.int64) * (c & 0xFFFFFFFF))


def seed_tables(device) -> tuple:
    """(SEED32, SEED32C) as int32 tensors on `device`."""
    return (
        torch.from_numpy(SEED32.view(np.int32).copy()).to(device),
        torch.from_numpy(SEED32C.view(np.int32).copy()).to(device),
    )
