"""The plain reference of a keyframe check's place-recognition query (DBoW2,
as the reference system's CBoWManager uses it).

Each valid descriptor of a frame takes the vocabulary word nearest to it
by Hamming distance (the first on ties); the frame's vector is the TF-IDF
histogram (each word's idf weight once per descriptor that takes it),
L1-normalized; a query scores every stored keyframe by DBoW2's L1 score,
sum over words of (|v_i| + |w_i| - |v_i - w_i|) / 2 (0 against an empty
vector), and ranks them, ties to the lower id. Plain
torch in ``dtype``; nothing of the program.
"""

from __future__ import annotations

import torch


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Descriptors packed as 32-bit words [..., 8] -> bits {0,1} [..., 256]
    (bit i is bit i % 32 of word i // 32)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., :, None] >> torch.arange(32, device=w.device)) & 1
    return bits.reshape(*w.shape[:-1], w.shape[-1] * 32)


def words_of(desc: torch.Tensor, leaf_bits: torch.Tensor) -> torch.Tensor:
    """The nearest word of each packed descriptor [N, 8] among the
    vocabulary's bits [W, 256] ({0,1}); integer Hamming distances."""
    d = unpack_bits(desc).to(torch.int32)
    v = leaf_bits.to(torch.int32)
    out = []
    for blk in torch.split(d, 2048):
        # |a xor b| = |a| + |b| - 2 a.b, integers throughout
        dist = blk.sum(-1, keepdim=True) + v.sum(-1)[None] - 2 * (
            blk.to(torch.float64) @ v.to(torch.float64).T).round().to(torch.int32)
        out.append(torch.argmin(dist, -1))
    return torch.cat(out)


def vectors(desc: torch.Tensor, valid: torch.Tensor, leaf_bits: torch.Tensor,
            weights: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """The L1-normalized TF-IDF vectors [F, W] of F frames' packed
    descriptors [F, K, 8] with their validity [F, K]."""
    F, K = valid.shape
    word = words_of(desc.reshape(F * K, -1), leaf_bits).reshape(F, K)
    w = weights.to(dtype)
    v = torch.zeros(F, leaf_bits.shape[0], dtype=dtype, device=desc.device)
    v.scatter_add_(1, word, torch.where(valid, w[word], torch.zeros((), dtype=dtype,
                                                                     device=desc.device)))
    return v / torch.clamp(v.sum(-1, keepdim=True), min=torch.finfo(dtype).tiny)


def scores(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 score of a query vector [W] against each row of ``db``."""
    q = query[None]
    return 0.5 * torch.sum(torch.abs(q) + torch.abs(db) - torch.abs(db - q), -1)


def rank(s: torch.Tensor, k: int):
    """The ``k`` best scores and their ids, ties to the lower id."""
    order = sorted(range(s.shape[0]), key=lambda i: (-float(s[i]), i))[:k]
    return s[order], torch.tensor(order, dtype=torch.int64)
