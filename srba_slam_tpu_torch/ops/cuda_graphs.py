"""Loops whose body replays as one CUDA graph.

The iterative solves of the port (the GN pose solve, the window LM loop,
the pose graph) run a pure step ``step(c, k) -> c`` on a carry ``c`` over
fixed inputs ``k`` (dicts of tensors, or of lists of tensors). On a card,
``loop`` captures the step once per shape and replays it: one launch a
step in place of one a kernel, the same kernels, so the same bits as the
eager steps.

Where the carry has ``more`` ("still active"), ``loop`` reads it on the
host between two steps and stops early; inside :func:`no_exit_reads` it
runs all ``n`` steps without reading (each step masks its updates by the
loop's condition, so the bits are the same). The pipelined batched loop
dispatches its scans, window solves and keyframe checks so, and reads the
host once a batch. On a card a step whose carry has ``more`` replays as
the body of a CUDA-graph conditional node on it (``csrc/graph_cond.cu``):
a replay past the exit runs no kernel of the step, so the steps run unread
cost a launch each, not a masked step.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from srba_slam_tpu_torch.ops import cuda_build

# The captured steps, by their static options and shapes: captured at a
# key's first call, replayed after.
_GRAPHS: dict = {}
# False inside no_exit_reads(): loops run to their step cap unread
_READ_EXITS = True


@contextlib.contextmanager
def no_exit_reads():
    """Within the block, every ``loop`` runs its ``n`` steps without
    reading its exit test on the host."""
    global _READ_EXITS
    prev, _READ_EXITS = _READ_EXITS, False
    try:
        yield
    finally:
        _READ_EXITS = prev


def _stop(i: int, c: dict) -> bool:
    """The host's exit test before step ``i``: the carry's ``more`` read,
    where there is one and reads are on."""
    return bool(_READ_EXITS and i and "more" in c and not bool(c["more"]))


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.cholesky_solve`` of one right-hand side ``b`` [m] with the
    lower factor ``L`` [m, m], as its two triangular solves (the same
    algebra; on the CPU within float rounding of LAPACK's potrs). Inside a
    capture on a card it records no stream-ordered allocation, which
    cuSOLVER's potrs does and a conditional node's body cannot hold."""
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


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
    it is False (not inside :func:`no_exit_reads`). On a CUDA device with
    ``graphs``, the steps are replays of one CUDA graph of ``step``
    (``_replay``); eager otherwise."""
    if graphs and n > 0 and next(_tensors(k)).device.type == "cuda":
        return _replay(step, c, k, n, static)
    for i in range(n):
        if _stop(i, c):
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
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # captured on this device's stream: torch.cuda.graph's default
            # capture stream is one for the process, on the first device
            # that captured
            with torch.cuda.graph(graph, stream=side):
                out = step(sc, sk)
                for name, v in out.items():
                    sc[name].copy_(v)
            entry = _GRAPHS[key] = (graph, _while_more(graph, sc), sc, sk)
        graph, launch, sc, sk = entry
        _copy_into(sc, c)
        _copy_into(sk, k)
        for i in range(n):
            if _stop(i, sc):
                break
            launch()
        return {name: v.clone() for name, v in sc.items()}


def _while_more(graph, sc: dict):
    """The launch of a captured step: where its carry has ``more``, the
    step as the body of a conditional node that runs it only while
    ``more`` is True on the device (a step past the exit leaves its carry
    as it was, so skipping it gives the same bits); else the graph's
    replay. The graph (and its memory pool) stays with the cache entry."""
    if "more" not in sc:
        return graph.replay
    lib = cuda_build.load()
    exec_ = ctypes.c_void_p()
    code = lib.srba_cond_graph_create(graph.raw_cuda_graph(), sc["more"].data_ptr(),
                                      ctypes.byref(exec_))
    if code != 0:
        raise RuntimeError(f"srba_cond_graph_create failed: cudaError {code}")
    dev = sc["more"].device

    def launch():
        code = lib.srba_cond_graph_launch(exec_, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"srba_cond_graph_launch failed: cudaError {code}")

    return launch
