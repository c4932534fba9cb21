"""JAX's default PRNG (threefry2x32, partitionable layout) in torch.

Counterpart of the ``jax.random`` calls on the estimator's path:
``PRNGKey(seed)`` per keyframe check (from a host int, or from a seed
already on the device) and per loop-closure re-check
(``models/data_association.py``), ``split(key, S)`` over the DA
candidates, and ``uniform(key, (n_hyp, K))`` for the RANSAC draws
(``ops/ransac.py``). The bits are JAX's for its default ``threefry2x32``
implementation with ``jax_threefry_partitionable=True``: element ``i`` of a
row-major draw hashes the 64-bit counter ``i`` (as the word pair
``(i >> 32, i & 0xffffffff)``) under the key, and a 32-bit draw is the XOR
of the two output words. Same seed, same hypotheses, so the port's DA
decisions follow JAX's instead of diverging statistically.

Keys are int64 tensors ``[..., 2]`` holding the two uint32 words (torch's
uint32 lacks the arithmetic); every sum and shift is masked back to 32
bits. Everything runs on the key's device. ``split`` and ``uniform`` take a
batch of keys ``[L, 2]`` as well (the DA cascade's candidates, one key
each): lane ``j`` draws exactly what the key ``j`` alone draws.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on uint32 words held
    in int64 tensors; keys broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def check_seed(seed: int) -> int:
    """``seed`` as an int, refused outside [0, 2^32): the range JAX's
    PRNGKey seeds a key from. A seed drawn on the host is checked here,
    where it is drawn, before it goes to the device."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return seed


def PRNGKey(seed, device=None) -> torch.Tensor:
    """≙ ``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32): the words
    ``(0, seed)``, as JAX's threefry seeding of a 32-bit integer. ``seed``
    is a Python int (checked by :func:`check_seed`, built on the host) or
    an integer scalar tensor (the key built on its device, no copy: the
    seed of a captured program is one of its inputs; its range was checked
    where it was drawn, and it is taken as uint32, as JAX takes it)."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(device=device or seed.device, dtype=torch.int64).reshape(()) & _M32
        return torch.stack([torch.zeros_like(s), s])
    seed = check_seed(seed)
    # built on the host and sent without waiting: a blocking copy would
    # synchronize the host with the card once a keyframe check
    return torch.tensor([0, seed], dtype=torch.int64).to(device, non_blocking=True)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """≙ ``jax.random.split(key, n)``: keys ``[..., n, 2]`` for keys
    ``[..., 2]``."""
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws ``[..., *shape]`` for keys ``[..., 2]`` (values in
    [0, 2^32) as int64)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """≙ ``jax.random.uniform(key, shape)`` (float32 in [0, 1)), per key of
    ``[..., 2]``: the top 23 bits of each draw as the mantissa of a float
    in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
