"""Loops whose body replays as one CUDA graph.

The iterative solves of the port (the GN pose solve, the window LM loop,
the pose graph) run a pure step ``step(c, k) -> c`` on a carry ``c`` over
fixed inputs ``k`` (dicts of tensors, or of lists of tensors). On a card,
``loop`` captures the step once per shape and replays it: one launch a
step in place of one a kernel, the same kernels, so the same bits as the
eager steps.
"""

from __future__ import annotations

import torch

# The captured steps, by their static options and shapes: captured at a
# key's first call, replayed after.
_GRAPHS: dict = {}


def _tensors(d: dict):
    for _name, v in sorted(d.items()):
        yield from (v if isinstance(v, list) else [v])


def _clone(d: dict) -> dict:
    return {name: [t.clone() for t in v] if isinstance(v, list) else v.clone()
            for name, v in d.items()}


def _copy_into(dst: dict, src: dict):
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def loop(step, c: dict, k: dict, n: int, static: tuple, graphs: bool) -> dict:
    """Up to ``n`` steps ``c = step(c, k)``. Where the carry has ``more``
    ("still active"), the host reads it between two steps and stops once
    it is False. On a CUDA device with ``graphs``, the steps are replays of
    one CUDA graph of ``step`` (``_replay``); eager otherwise."""
    if graphs and n > 0 and next(_tensors(k)).device.type == "cuda":
        return _replay(step, c, k, n, static)
    for i in range(n):
        if i and "more" in c and not bool(c["more"]):
            break
        c = step(c, k)
    return c


def _replay(step, c: dict, k: dict, n: int, static: tuple) -> dict:
    """``loop`` as replays of one CUDA graph of ``step`` on fixed buffers,
    keyed by ``static`` (the step's options), the device and the shapes of
    ``c`` and ``k``, captured at a key's first call. The inputs are copied
    in and the carry cloned out, so callers share a graph. The warm-up, the
    capture and the replays run on the inputs' device and its current
    stream, whichever device is current."""
    dev = next(_tensors(k)).device
    key = (static, dev, tuple(tuple(t.shape) for t in _tensors(c)),
           tuple(tuple(t.shape) for t in _tensors(k)))
    with torch.cuda.device(dev):
        entry = _GRAPHS.get(key)
        if entry is None:
            sc, sk = _clone(c), _clone(k)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):  # library handles and workspaces first
                step(sc, sk)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # captured on this device's stream: torch.cuda.graph's default
            # capture stream is one for the process, on the first device
            # that captured
            with torch.cuda.graph(graph, stream=side):
                out = step(sc, sk)
                for name, v in out.items():
                    sc[name].copy_(v)
            entry = _GRAPHS[key] = (graph, sc, sk)
        graph, sc, sk = entry
        _copy_into(sc, c)
        _copy_into(sk, k)
        for i in range(n):
            if i and "more" in sc and not bool(sc["more"]):
                break
            graph.replay()
        return {name: v.clone() for name, v in sc.items()}
