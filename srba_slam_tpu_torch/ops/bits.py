"""Binary-descriptor bit manipulation on int32 bit patterns.

Counterpart of ``srba_slam_tpu/ops/bits.py``. Descriptors are 256-bit
strings packed into 8 words; global bit ``i`` lives in word ``i // 32`` at
position ``i % 32`` (the reference's byte-LSB-first order, src/CBoWManager.h:95-109).

The JAX package stores the words as uint32. torch's uint32 lacks shifts and
comparisons, so the port stores the same bit patterns as int32
(``.numpy().view(np.uint32)`` gives JAX's words back) and counts bits in
int64, where no sign bit gets in the way.
"""

from __future__ import annotations

import torch


def unpack_bits(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """int32[..., W] -> {0,1} [..., W*32] in the global bit order above."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    # arithmetic shift: bit 31 of a negative word still lands in bit 0
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} [..., W*32] -> int32[..., W] (the uint32 words' bit patterns)."""
    n_words = bits.shape[-1] // 32
    b = bits.reshape(*bits.shape[:-1], n_words, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)              # in [0, 2^32)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def pack_bytes_to_words(desc_bytes: torch.Tensor) -> torch.Tensor:
    """uint8[..., 32] descriptor bytes -> int32[..., 8] words (little-endian)."""
    n_words = desc_bytes.shape[-1] // 4
    b = desc_bytes.reshape(*desc_bytes.shape[:-1], n_words, 4).to(torch.int64)
    shifts = torch.arange(4, dtype=torch.int64, device=desc_bytes.device) * 8
    words = torch.sum(b << shifts, dim=-1)              # in [0, 2^32)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def words_to_bytes(packed: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> uint8[..., W*4] (little-endian), the reference's
    cv::Mat row layout."""
    shifts = torch.arange(4, dtype=torch.int32, device=packed.device) * 8
    by = (packed[..., :, None] >> shifts) & 0xFF
    return by.reshape(*packed.shape[:-1], packed.shape[-1] * 4).to(torch.uint8)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns -> int64 (SWAR in int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def popcount_desc(packed: torch.Tensor) -> torch.Tensor:
    """Total set bits per descriptor: int32[..., W] -> int32[...]."""
    return torch.sum(popcount32(packed), dim=-1).to(torch.int32)
