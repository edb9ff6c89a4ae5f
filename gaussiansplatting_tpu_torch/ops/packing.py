"""Two bf16 values in one 32-bit word: the bf16 payload mode's packing.

Counterpart of gaussiansplatting_tpu/ops/packing.py, on torch tensors.  With
``RasterConfig.payload_dtype="bf16"`` the pair table carries conic, opacity
and colour (and, with ``pack_positions``, the tile-relative position) as
pairs of bf16 values in float32-typed words, and the blend backward writes
its nine cotangents as five such words (ops/pairs.py, ops/blend.py).

Rounding is round-to-nearest-even done in integer arithmetic on the float's
bits, as the JAX package does it, so the packed words here equal JAX's bit
for bit (the CUDA kernels use the same formula).  On int32, ``>>`` is an
arithmetic shift and 0xFFFF0000 is -65536.
"""

from __future__ import annotations

import torch

_HI = -65536          # 0xFFFF0000 as an int32


def _rne_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of float32 ``x`` rounded to bf16 (round to nearest, ties
    to even), still in the high half: u + 0x7FFF + bit 16 of u, then the low
    16 bits cleared."""
    u = x.contiguous().view(torch.int32)
    return (u + 0x7FFF + ((u >> 16) & 1)) & _HI


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and back to float32 (round to nearest even)."""
    return _rne_bits(x).view(torch.float32)


def pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One float32-typed tensor whose bits hold bf16(a) << 16 | bf16(b)."""
    return (_rne_bits(a) | ((_rne_bits(b) >> 16) & 0xFFFF)).view(torch.float32)


def unpack2(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack2: (a, b) as float32, exact bf16 values."""
    u = p.contiguous().view(torch.int32)
    return (u & _HI).view(torch.float32), (u << 16).view(torch.float32)


def pack_cols(cols: list[torch.Tensor]) -> list[torch.Tensor]:
    """Pack consecutive columns in pairs; an odd last one pairs with
    zeros."""
    return [pack2(cols[i], cols[i + 1] if i + 1 < len(cols) else torch.zeros_like(cols[i]))
            for i in range(0, len(cols), 2)]


def unpack_cols(packed: list[torch.Tensor], n: int) -> list[torch.Tensor]:
    """Inverse of pack_cols: the first ``n`` unpacked columns."""
    out = []
    for p in packed:
        out.extend(unpack2(p))
    return out[:n]
