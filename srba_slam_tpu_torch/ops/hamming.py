"""Pairwise Hamming distance of packed 256-bit descriptors.

Counterpart of ``srba_slam_tpu/ops/hamming.py``. The JAX package rides the
TPU's matrix unit with a bf16 matmul of unpacked bits; here the distance is
XOR plus popcount over the 8 words, which is exact on any device. The
result is f32, as in the JAX package, so the matchers compare like with like.
"""

from __future__ import annotations

import torch

from srba_slam_tpu_torch.ops.bits import popcount32, popcount_desc


def hamming_matrix(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """int32[..., N, 8] x int32[..., M, 8] packed descriptors -> f32[..., N, M]
    distances (leading dimensions broadcast)."""
    x = torch.bitwise_xor(a_packed[..., :, None, :], b_packed[..., None, :, :])
    return torch.sum(popcount32(x), dim=-1).to(torch.float32)


def hamming_matrix_unpacked(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """{0,1} [N,256] x [M,256] -> f32 [N,M] exact Hamming distances:
    pop(a) + pop(b) - 2 a.b, every term an integer <= 256, exact in f32."""
    a = a_bits.to(torch.float32)
    b = b_bits.to(torch.float32)
    return torch.sum(a, dim=-1)[:, None] + torch.sum(b, dim=-1)[None, :] - 2.0 * (a @ b.T)


def hamming_pairs(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of aligned descriptor rows:
    int32[N,8] x int32[N,8] -> int32[N]."""
    return popcount_desc(torch.bitwise_xor(a_packed, b_packed))
