"""Bag-of-binary-words place recognition (≙ DBoW2 + CBoWManager).

Counterpart of ``srba_slam_tpu/models/bow.py`` (reference
src/CBoWManager.h:48-88: load a vocabulary, insert keyframes, query the
ranked similar keyframes), with the same design:

* every descriptor takes its exact Hamming-nearest leaf word (the first
  one on ties) from one [K, 256] x [256, W] product of {0,1} bits, exact in
  float32;
* TF-IDF L1-normalized BoW vectors, so the DBoW2 L1 score equals
  ``Σ min(v, w)`` and a query scores the whole dense [MAX_KFS, W] database
  at once;
* database entry id == keyframe id.

The histogram is a one-hot sum, never a scatter-add, so it is the same on
every run of the card. ``Vocabulary`` is host numpy, as in the JAX
package; its training is bit-identical to JAX's.

On a card the database's writes are CUDA-graph programs (``ROW_PROGRAMS``),
as they are single dispatches in the JAX package: ``write_row`` (≙
``_insert``, the BoW vector computed inside) and ``rebuild_from_store``
(≙ ``_rebuild``: every row from the store's descriptors, one row at a time
inside the graph, masked past the count). Rows and counts are device
inputs; the database, the vocabulary and the store's descriptors are held
in place, and the programs are freed with them.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass

import numpy as np
import torch

from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.ops.bits import unpack_bits
from srba_slam_tpu_torch.utils import trace

# On a CUDA device, BoWDatabase.write_row and rebuild_from_store are each one
# replay of a CUDA-graph program per database; eager launches otherwise (the
# CPU path, and the card's reference in the tests and chip_smoke.py)
ROW_PROGRAMS = True


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def unpack_bits_np(packed: np.ndarray) -> np.ndarray:
    """uint32/int32 words [..., 8] -> int8 {0,1} [..., 256]: global bit i
    is bit i % 32 of word i // 32 (``ops/bits.py``'s order)."""
    words = np.ascontiguousarray(packed).view(np.uint32)
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).astype(np.int8)


@dataclass
class Vocabulary:
    """Flat leaf-word vocabulary: bits + idf weights, padded to a static W."""

    leaf_bits: np.ndarray      # int8 [W_pad, 256] {0,1}; padding rows zero
    weights: np.ndarray        # f32 [W_pad]; padding weight 0
    n_words: int               # true number of words (<= W_pad)
    k: int = 0                 # branching factor of the source tree (info only)
    L: int = 0                 # depth of the source tree (info only)

    @property
    def n_pad(self) -> int:
        return self.leaf_bits.shape[0]

    @staticmethod
    def from_jax_numpy(voc) -> "Vocabulary":
        """The port's copy of a JAX package ``Vocabulary``."""
        return Vocabulary(np.array(voc.leaf_bits, np.int8), np.array(voc.weights, np.float32),
                          int(voc.n_words), int(voc.k), int(voc.L))

    # -- loading the reference's DBoW2 YAML format --------------------------
    @staticmethod
    def load_dbow2(path: str) -> "Vocabulary":
        """Parse a DBoW2 vocabulary .yml / .yml.gz (demo/voc.yml.gz format)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", errors="replace") as f:
            txt = f.read()
        k = int(re.search(r"\bk:\s*(\d+)", txt).group(1))
        L = int(re.search(r"\bL:\s*(\d+)", txt).group(1))
        node_re = re.compile(
            r"nodeId:(\d+),\s*parentId:\d+,\s*weight:([0-9.eE+-]+),\s*"
            r'descriptor:"([01]+)"',
            re.S,
        )
        weights = {}
        descs = {}
        for m in node_re.finditer(txt):
            nid = int(m.group(1))
            weights[nid] = float(m.group(2))
            descs[nid] = m.group(3)
        word_re = re.compile(r"wordId:(\d+),\s*nodeId:(\d+)")
        words = sorted((int(m.group(1)), int(m.group(2))) for m in word_re.finditer(txt))
        n_words = len(words)
        n_pad = _round_up(max(n_words, 128), 128)
        bits = np.zeros((n_pad, 256), np.int8)
        w = np.zeros((n_pad,), np.float32)
        for word_id, node_id in words:
            s = descs[node_id]
            bits[word_id] = np.frombuffer(s.encode(), np.uint8) - ord("0")
            w[word_id] = weights[node_id]
        return Vocabulary(bits, w, n_words, k, L)

    # -- native (.npz) save/load ---------------------------------------------
    def save(self, path: str):
        """Save in the framework's own compact format (.npz)."""
        if not path.endswith(".npz"):
            path += ".npz"  # savez appends it anyway; keep load symmetric
        np.savez_compressed(path, leaf_bits=self.leaf_bits, weights=self.weights,
                            meta=np.asarray([self.n_words, self.k, self.L]))

    @staticmethod
    def load(path: str) -> "Vocabulary":
        import os

        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"
        d = np.load(path)
        n_words, k, L = map(int, d["meta"])
        return Vocabulary(d["leaf_bits"], d["weights"], n_words, k, L)

    # -- training from scratch ---------------------------------------------
    @staticmethod
    def train(descriptors: np.ndarray, k: int = 8, L: int = 5,
              seed: int = 0, min_cluster: int = 2) -> "Vocabulary":
        """Hierarchical binary k-medians over packed [N, 8] descriptors
        (uint32 words or their int32 bit patterns). Leaf weights are idf
        over the training set: w_i = log(N / N_i)."""
        rng = np.random.default_rng(seed)
        bits = unpack_bits_np(np.asarray(descriptors))
        leaves: list[np.ndarray] = []   # majority-bit centroid per leaf
        counts: list[int] = []

        def kmedians(idx: np.ndarray, depth: int):
            if depth == L or len(idx) < max(k, min_cluster):
                centroid = (bits[idx].mean(axis=0) >= 0.5).astype(np.int8)
                leaves.append(centroid)
                counts.append(len(idx))
                return
            centers = bits[rng.choice(idx, size=k, replace=False)].astype(np.int32)
            sub = bits[idx].astype(np.int32)
            for _ in range(6):
                d = np.abs(sub[:, None, :] - centers[None, :, :]).sum(-1)
                assign = d.argmin(1)
                for c in range(k):
                    sel = sub[assign == c]
                    if len(sel):
                        centers[c] = (sel.mean(0) >= 0.5).astype(np.int32)
            for c in range(k):
                sel = idx[assign == c]
                if len(sel):
                    kmedians(sel, depth + 1)

        kmedians(np.arange(len(bits)), 0)
        n_words = len(leaves)
        n_pad = _round_up(max(n_words, 128), 128)
        leaf_bits = np.zeros((n_pad, 256), np.int8)
        leaf_bits[:n_words] = np.stack(leaves)
        n_total = len(bits)
        w = np.zeros((n_pad,), np.float32)
        w[:n_words] = np.log(n_total / np.maximum(np.asarray(counts, np.float32), 1.0))
        return Vocabulary(leaf_bits, w, n_words, k, L)


def bow_vector(desc_packed: torch.Tensor, valid: torch.Tensor,
               leaf_bits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Quantize K packed descriptors int32 [..., K, 8] to leaf words and
    build the TF-IDF L1-normalized BoW vector f32 [..., W_pad] (leading
    dimensions are separate frames). ``leaf_bits`` is the vocabulary's
    {0,1} bits as f32 [W_pad, 256]."""
    db = unpack_bits(desc_packed, torch.float32)             # [..., K, 256]
    # Hamming = pop(d) + pop(w) - 2 d.w; pop(d) is constant per row. Every
    # term is an integer <= 256, exact in f32 whatever the summation order
    dot = db @ leaf_bits.T                                   # [..., K, W]
    dist = torch.sum(leaf_bits, dim=-1) - 2.0 * dot
    w_pad = dist.shape[-1]
    word = torch.argmin(dist, dim=-1)                        # first minimum on ties
    contrib = torch.where(valid, weights[word], 0.0)
    onehot = word[..., None] == torch.arange(w_pad, device=dist.device)
    v = torch.sum(torch.where(onehot, contrib[..., None], 0.0), dim=-2)
    n = torch.sum(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-12)


def rank_scores(scores: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` does not order ties)."""
    s, i = torch.sort(scores, descending=True, stable=True)
    return s[..., :k], i[..., :k].to(torch.int32)


def write_row_body(x: dict) -> tuple:
    """The row program: the BoW vector of ``x["desc"]``/``x["valid"]``
    (:func:`bow_vector` with the vocabulary's ``x["leaf_bits"]`` and
    ``x["weights"]``) written into the database ``x["db"]`` at the device
    row ``x["row"]`` (int64 [1]), in place (≙ the JAX package's
    ``_insert``). No host read; returns nothing."""
    v = bow_vector(x["desc"], x["valid"], x["leaf_bits"], x["weights"])
    x["db"].index_copy_(0, x["row"], v[None])
    return ()


def rebuild_body(x: dict) -> tuple:
    """The rebuild program: every row i of the database ``x["db"]`` [M, W]
    set to the BoW vector of the store's row i (``x["desc"]`` [M, K, 8],
    ``x["valid"]`` [M, K]) where i < ``x["n_kfs"]`` (a device scalar), else
    zero (≙ the JAX package's ``_rebuild``). One row at a time, so the
    largest intermediate is one row's [K, W] and each row has the bits of
    a one-row :func:`bow_vector`. No host read; returns nothing."""
    db, n = x["db"], x["n_kfs"]
    for i in range(db.shape[0]):
        v = bow_vector(x["desc"][i], x["valid"][i], x["leaf_bits"], x["weights"])
        db[i].copy_(torch.where(n > i, v, 0.0))
    return ()


def _programs(device: torch.device) -> bool:
    return ROW_PROGRAMS and device.type == "cuda" and not cuda_graphs.in_program()


class BoWDatabase:
    """≙ BriefDatabase: insert/query over KF BoW vectors (entry id == KF id)."""

    def __init__(self, voc: Vocabulary, max_kfs: int = 512, device="cuda"):
        self.voc = voc
        self.max_kfs = max_kfs
        self.device = torch.device(device)
        self._leaf_bits = torch.as_tensor(voc.leaf_bits, device=self.device).to(torch.float32)
        self._weights = torch.as_tensor(voc.weights, device=self.device)
        self._db = torch.zeros((max_kfs, voc.n_pad), dtype=torch.float32, device=self.device)
        self.n_kfs = 0

    @staticmethod
    def from_jax_numpy(voc, db: np.ndarray, n_kfs: int, device="cuda") -> "BoWDatabase":
        """A database holding the JAX package's rows: ``voc`` its
        Vocabulary, ``db`` = ``jax.device_get(bow._db)``."""
        out = BoWDatabase(Vocabulary.from_jax_numpy(voc), db.shape[0], device)
        out._db = torch.as_tensor(np.array(db, np.float32), device=out.device)
        out.n_kfs = int(n_kfs)
        return out

    def compute_bow(self, desc_packed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return bow_vector(desc_packed, valid, self._leaf_bits, self._weights)

    def _held(self) -> dict:
        return dict(db=self._db, leaf_bits=self._leaf_bits, weights=self._weights)

    def rebuild_from_store(self, store_arrays, n_kfs: int):
        """Backfill rows [0, n_kfs) from the keyframe store's descriptors,
        the rows past them zero (entry id == KF id contract preserved). On a
        card (``ROW_PROGRAMS``) one replay of the rebuild program
        (:func:`rebuild_body`, ``n_kfs`` a device input, the database, the
        vocabulary and the store's descriptors held); eagerly the rows
        under ``n_kfs`` one at a time, the same bits."""
        if _programs(self.device):
            cuda_graphs.program(
                rebuild_body, dict(n_kfs=cuda_graphs.upload(int(n_kfs), self.device,
                                                            torch.int64)),
                ("bow_rebuild",),
                held=dict(self._held(), desc=store_arrays.desc_l, valid=store_arrays.m_valid))
        else:
            self._db.zero_()
            for i in range(n_kfs):
                self._db[i] = self.compute_bow(store_arrays.desc_l[i], store_arrays.m_valid[i])
        self.n_kfs = n_kfs

    def write_row(self, desc_packed: torch.Tensor, valid: torch.Tensor, row: int):
        """Write a keyframe's BoW vector at ``row`` without committing the
        entry count (≙ the JAX database's ``write_row``): a row at or past
        ``n_kfs`` never scores, so a speculative write is inert. The row
        goes up as a device input (one upload); on a card (``ROW_PROGRAMS``)
        the write is one replay of the database's row program
        (:func:`write_row_body`), the same bits as the eager write."""
        assert row < self.max_kfs, f"BoW database full ({self.max_kfs} keyframes)"
        x = dict(desc=desc_packed, valid=valid,
                 row=cuda_graphs.upload([int(row)], self.device, torch.int64))
        if _programs(self.device):
            cuda_graphs.program(write_row_body, x, ("bow_row",), held=self._held())
        else:
            write_row_body({**x, **self._held()})

    def commit_row(self) -> int:
        """Commit the next row; returns its entry id (== KF id)."""
        self.n_kfs += 1
        return self.n_kfs - 1

    def insert(self, desc_packed: torch.Tensor, valid: torch.Tensor) -> int:
        """Insert a keyframe's descriptors; returns its DB entry id (== KF id)."""
        self.write_row(desc_packed, valid, self.n_kfs)
        return self.commit_row()

    def scores(self, q: torch.Tensor, n_kfs: int) -> torch.Tensor:
        """L1 scores of BoW vector ``q`` against every row; -1 past ``n_kfs``."""
        s = torch.sum(torch.minimum(self._db, q[None, :]), dim=-1)
        rows = torch.arange(self._db.shape[0], device=s.device)
        return torch.where(rows < n_kfs, s, -1.0)

    def query(self, desc_packed: torch.Tensor, valid: torch.Tensor, max_results: int = 4):
        """Ranked (scores, ids) numpy of the most similar stored KFs
        (≙ CBoWManager::queryDB, reference src/CBoWManager.h:83-88)."""
        s, i = rank_scores(self.scores(self.compute_bow(desc_packed, valid), self.n_kfs),
                           max_results)
        return trace.to_numpy("bow.query", s), trace.to_numpy("bow.query", i)
