"""The deployments' bag-of-words vocabulary: built once, cached in the checkout.

A DBoW2 vocabulary of the upstream's shape (``demo/voc.yml.gz``: k = 8
branches, L = 5 levels, 8^5 = 32,768 leaf words) trained with plain torch
from a fixed seed of its own, as a deployment's vocabulary is made once and
then fixed: hierarchical k-majority clustering (Hamming distance, each
centre bit the majority of its members', ties to 1, as DBoW2's binary
descriptors do) of the upright ORB descriptors that the benchmark's
reference frontend finds on a training drive rendered from that seed, and
the inverse document frequency of each leaf over the training frames
(DBoW2's TF-IDF weighting). A node with no more descriptors than branches
takes each as a leaf. A specification may keep only the first leaves, as
many as a multiple of ``multiple_of``.

``load_or_build`` keeps the result under ``slam_bench/_cache/`` at a fixed
path keyed by the vocabulary's specification, so only the first run in a
checkout builds it. Every step is exact integer arithmetic in float32 or a
seeded draw, so every build from one specification is the same.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from slam_bench import render
from slam_bench.reference import frontend

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")


def _bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words [N, 8] -> float32 {0,1} [N, 256], bit i = bit i % 32 of word i // 32."""
    b = (words[..., None] >> torch.arange(32, device=words.device, dtype=torch.int32)) & 1
    return b.reshape(words.shape[0], 256).to(torch.float32)


def _nearest(x: torch.Tensor, c: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """Index of the Hamming-nearest row of ``c`` [M, 256] for each row of
    ``x`` [N, 256] (the first on ties): |x| + |c| - 2 x.c, exact in float32."""
    out = []
    cn = c.sum(1)
    for i in range(0, x.shape[0], chunk):
        xi = x[i:i + chunk]
        out.append(torch.argmin(xi.sum(1)[:, None] + cn[None, :] - 2.0 * (xi @ c.T), dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=x.device)


def kmajority_tree(x: torch.Tensor, k: int, levels: int, seed: int, iters: int = 10):
    """Leaf centres [k^levels, 256] (float {0,1}) and whether each holds a
    word, of the k-majority tree of ``x`` [N, 256]: every node of a level is
    split at once, its descriptors in ``k`` clusters started at ``k`` of them
    drawn from ``seed``."""
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    n_nodes = 1
    for _ in range(levels):
        counts = torch.bincount(node, minlength=n_nodes)
        # k starting members a node: the k lowest of a random key within it
        key = (torch.rand(x.shape[0], generator=gen, device=dev, dtype=torch.float64)
               + node.to(torch.float64) * 2.0)
        order = torch.sort(key, stable=True).indices
        start = torch.cumsum(counts, 0) - counts
        pick = start[:, None] + torch.arange(k, device=dev)[None, :]
        live = torch.arange(k, device=dev)[None, :] < counts[:, None]
        centers = x[order[torch.where(live, pick, 0).clamp(max=max(x.shape[0] - 1, 0))]]
        centers = torch.where(live[..., None], centers, 0.0)            # [n_nodes, k, 256]
        small = counts <= k      # each descriptor its own leaf
        child = torch.zeros_like(node)
        for _it in range(iters):
            flat = centers.reshape(n_nodes * k, 256)
            d = torch.cat([
                (x[i:i + 65536].sum(1)[:, None]
                 + flat.reshape(n_nodes, k, 256)[node[i:i + 65536]].sum(2)
                 - 2.0 * torch.einsum("nd,nkd->nk", x[i:i + 65536],
                                      flat.reshape(n_nodes, k, 256)[node[i:i + 65536]]))
                for i in range(0, x.shape[0], 65536)])
            d = torch.where(live[node], d, float("inf"))
            child = torch.argmin(d, dim=1)
            slot = node * k + child
            ones = torch.zeros(n_nodes * k, 256, device=dev).index_add_(0, slot, x)
            size = torch.bincount(slot, minlength=n_nodes * k).to(torch.float32)
            new = (2.0 * ones >= size[:, None]).to(torch.float32).reshape(n_nodes, k, 256)
            filled = (size > 0).reshape(n_nodes, k)
            centers = torch.where((filled & ~small[:, None])[..., None], new, centers)
        # a small node: its members, in the order of the draw, one a child
        pos = torch.empty_like(node)
        pos[order] = torch.arange(x.shape[0], device=dev) - start[node[order]]
        child = torch.where(small[node], pos, child)
        live = torch.where(small[:, None], live, live & (torch.bincount(
            node * k + child, minlength=n_nodes * k).reshape(n_nodes, k) > 0))
        node = node * k + child
        n_nodes *= k
    leaf = torch.zeros(n_nodes, 256, device=dev).index_add_(0, node, x)
    size = torch.bincount(node, minlength=n_nodes).to(torch.float32)
    return (2.0 * leaf >= size[:, None]).to(torch.float32), size > 0


def build(spec: dict, device) -> dict:
    """The vocabulary of ``spec`` (the configurations' ``vocabulary``
    entry): ``leaf_bits`` int8 [W, 256], ``weights`` f32 [W], ``k``, ``L``."""
    cam = spec["camera"]
    eye = render.Camera(cam["fx_l"], cam["fy_l"], cam["cx_l"], cam["cy_l"], cam["width"],
                        cam["height"])
    eye_r = render.Camera(cam["fx_r"], cam["fy_r"], cam["cx_r"], cam["cy_r"], cam["width"],
                          cam["height"])
    drive = render.Drive((eye, eye_r), cam["baseline"], spec["train_frames"], spec["seed"],
                         spec["step"], device=device)
    words, doc = [], []
    for f0 in range(0, spec["train_frames"], 8):
        lefts, rights = drive.render(range(f0, min(f0 + 8, spec["train_frames"])))
        for j in range(lefts.shape[0]):
            feat = frontend.frontend(lefts[j], rights[j], cam, spec["fast_th"], 0, spec["features"])
            for d, v in ((feat.desc_l, feat.valid_l), (feat.desc_r, feat.valid_r)):
                words.append(d[v])
                doc.append(torch.full((int(v.sum()),), f0 + j, device=d.device))
    x = _bits(torch.cat(words))
    doc = torch.cat(doc)
    centers, ok = kmajority_tree(x, spec["k"], spec["L"], spec["seed"])
    centers = centers[ok]
    # ``multiple_of``: the first leaves, as many as the largest multiple of
    # it (the program pads its vocabulary to a multiple of 128 with zero
    # words, which a sparse descriptor can take: PERF.md §7)
    m = int(spec.get("multiple_of", 1))
    centers = centers[:centers.shape[0] // m * m]
    # idf over the training frames, each descriptor at its nearest leaf
    w_of = _nearest(x, centers)
    n_docs = spec["train_frames"]
    pairs = torch.unique(doc * centers.shape[0] + w_of)
    df = torch.bincount(pairs % centers.shape[0], minlength=centers.shape[0]).to(torch.float64)
    weights = torch.log(n_docs / torch.clamp(df, min=1.0)).to(torch.float32)
    return dict(leaf_bits=centers.to(torch.int8).cpu().numpy(), weights=weights.cpu().numpy(),
                k=spec["k"], L=spec["L"])


def cache_path(spec: dict) -> str:
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(CACHE_DIR, f"vocabulary-{key}.npz")


def load_or_build(spec: dict, device) -> tuple[dict, bool]:
    """The cached vocabulary of ``spec``, else one built now and cached;
    and whether it was built."""
    path = cache_path(spec)
    if os.path.exists(path):
        with np.load(path) as z:
            return dict(leaf_bits=z["leaf_bits"], weights=z["weights"], k=int(z["k"]),
                        L=int(z["L"])), False
    voc = build(spec, device)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **voc)
    os.replace(tmp, path)
    return voc, True
