"""Loops whose body replays as one CUDA graph.

The iterative solves of the port (the GN pose solve, the window LM loop,
the pose graph) run a pure step ``step(c, k) -> c`` on a carry ``c`` over
fixed inputs ``k`` (dicts of tensors, or of lists of tensors). On a card,
``loop`` captures the step once per shape and replays it: one launch a
step in place of one a kernel, the same kernels, so the same bits as the
eager steps.

Where the carry has ``more`` ("still active"), the eager ``loop`` reads
it on the host between two steps and stops early; inside
:func:`no_exit_reads` it runs all ``n`` steps without reading (each step
masks its updates by the loop's condition, so the bits are the same). The
pipelined batched loop dispatches its scans, window solves and keyframe
checks so, and reads the host once a batch. On a card the steps of a
carry with ``more`` are one launch of a graph that holds the captured
step in a conditional WHILE node (``csrc/graph_cond.cu``): it runs while
``more`` is set on the device and at most ``n`` times, with no host read,
so a step past the exit runs no kernel.

:func:`program` captures a whole computation whose loops run unread (a
batch's VO scan, ``models/vo.py`` ``vo_scan``) as one CUDA graph per key,
as the JAX package jits it once per shape: its inputs are copied into fixed
buffers, the graph replays, and its outputs are cloned out. Inside that
capture ``loop`` appends its steps to the graph as the same WHILE node
(``csrc/graph_cond.cu`` ``srba_cond_append``): the steps that the eager
launches run, the same bits. A program keeps its own captured steps
(captured in its warm-up), so no other caller of a step's key shares its
buffers. A capture or an append that fails raises; nothing falls back to
the eager launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from types import SimpleNamespace

import torch
from torch.utils import _pytree as pytree

from srba_slam_tpu_torch.ops import cuda_build

# The captured steps, by their static options and shapes: captured at a
# key's first call, replayed after.
_GRAPHS: dict = {}
# False inside no_exit_reads(): loops run to their step cap unread
_READ_EXITS = True
# The captured steps of the program being warmed up or captured (its own,
# in place of _GRAPHS), and the buffers its appended loops count steps in;
# None outside a program's capture
_BODIES: dict | None = None
_KEEP: list | None = None
# The captured programs, by key and the shapes of their inputs
_PROGRAMS: dict = {}
# Over the process: programs captured, and the host seconds of their
# warm-ups and captures
PROGRAM_STATS = dict(captures=0, capture_s=0.0)


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


def in_program() -> bool:
    """True inside a program's warm-up or capture (:func:`program`)."""
    return _BODIES is not None


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
    ``graphs``, the steps replay one CUDA graph of ``step`` (``_replay``);
    eager otherwise."""
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
    ``c`` and ``k``, captured at a key's first call: where the carry has
    ``more``, one launch of the step in a WHILE node (:func:`_while_more`),
    else ``n`` replays. The inputs are copied in and the carry cloned out,
    so callers share a graph. The warm-up, the capture and the replays run
    on the inputs' device and its current stream, whichever device is
    current."""
    dev = next(_tensors(k)).device
    key = (static, dev, tuple(tuple(t.shape) for t in _tensors(c)),
           tuple(tuple(t.shape) for t in _tensors(k)))
    cache = _GRAPHS if _BODIES is None else _BODIES
    with torch.cuda.device(dev):
        capturing = torch.cuda.is_current_stream_capturing()
        entry = cache.get(key)
        if entry is None:
            if capturing:
                raise RuntimeError(f"loop {static}: its step was not captured in the program's "
                                   "warm-up")
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
            entry = cache[key] = (graph, _while_more(graph, sc), sc, sk)
        graph, launch, sc, sk = entry
        _copy_into(sc, c)
        _copy_into(sk, k)
        if capturing:
            _append(graph, sc, n, dev)
        elif launch is not None:
            launch(n)
        else:
            for _ in range(n):
                graph.replay()
        return {name: v.clone() for name, v in sc.items()}


def _append(graph, sc: dict, n: int, dev):
    """The ``n`` launches of a captured step, appended to the program being
    captured on the current stream: one WHILE node on the carry's ``more``
    (at most ``n`` steps, counted in a buffer of the program)."""
    if "more" not in sc:
        raise RuntimeError("a loop inside a captured program needs a carry with 'more'")
    count = torch.empty((), dtype=torch.int32, device=dev)
    _KEEP.append(count)
    code = cuda_build.load().srba_cond_append(torch.cuda.current_stream(dev).cuda_stream,
                                              graph.raw_cuda_graph(), sc["more"].data_ptr(),
                                              count.data_ptr(), n)
    if code != 0:
        raise RuntimeError(f"srba_cond_append failed: cudaError {code}")


def _while_more(graph, sc: dict):
    """Where the carry has ``more``, the launch of up to ``n`` steps of a
    captured step: one executable graph for each ``n``, the step in a WHILE
    node that runs while ``more`` is True on the device and at most ``n``
    times (a step past the exit would leave its carry as it was, so skipping
    it gives the same bits); None where the carry has no ``more``. The
    graph (and its memory pool) stays with the cache entry."""
    if "more" not in sc:
        return None
    lib = cuda_build.load()
    dev = sc["more"].device
    count = torch.empty((), dtype=torch.int32, device=dev)     # the steps run
    execs = {}

    def launch(n: int):
        if n not in execs:
            exec_ = ctypes.c_void_p()
            code = lib.srba_cond_graph_create(graph.raw_cuda_graph(), sc["more"].data_ptr(),
                                              count.data_ptr(), n, ctypes.byref(exec_))
            if code != 0:
                raise RuntimeError(f"srba_cond_graph_create failed: cudaError {code}")
            execs[n] = exec_
        code = lib.srba_graph_launch(execs[n], torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"srba_graph_launch failed: cudaError {code}")

    return launch


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def program(fn, inputs: dict, key: tuple, counted=()):
    """``fn(inputs)`` on a card as one replay of a CUDA graph captured at
    the first call of ``key`` and of the inputs' shapes and dtypes.

    ``inputs`` is a dict of tensors on one CUDA device (or nests of them in
    tuples, named tuples and dicts, as ``torch.utils._pytree`` flattens
    them; any other leaf, such as None, is part of the key and stays as it
    is); ``fn`` returns such a nest. Each call copies the inputs into the program's buffers, launches
    the graph on the current stream and returns clones of its outputs, so
    a later call does not overwrite what an earlier one returned. ``key``
    holds everything else that ``fn`` bakes into its kernels (shapes it
    derives, options, Python numbers). ``counted`` are kernel wrappers with
    a ``launches`` count (``ops/hopper_fast.py``): a capture does not add
    to them, each replay adds the launches that the graph holds.

    A key's first call runs ``fn`` once eagerly on the buffers (the warm-up:
    it captures its loops' steps, each once, into the program's own cache,
    and sets up library handles), then captures ``fn`` with its loops as
    conditional nodes (:func:`loop`), without reading an exit test on the
    host. A capture that fails raises."""
    leaves, spec = pytree.tree_flatten(inputs)
    dev = next(t for t in leaves if _is_tensor(t)).device
    full_key = (key, repr(spec), dev, tuple((tuple(t.shape), t.dtype) if _is_tensor(t) else t
                                            for t in leaves))
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        prog = _PROGRAMS.get(full_key)
        if prog is None:
            prog = _PROGRAMS[full_key] = _capture(fn, leaves, spec, dev, tuple(counted), key)
        for d, s_ in zip(prog.static, leaves):
            if _is_tensor(d):
                d.copy_(s_)
        code = lib.srba_graph_launch(prog.exec_, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"srba_graph_launch failed: cudaError {code}")
        for wrapper, n in zip(prog.counted, prog.launches):
            wrapper.launches += n
        return pytree.tree_unflatten([t.clone() if _is_tensor(t) else t for t in prog.outs],
                                     prog.out_spec)


def _capture(fn, leaves, spec, dev, counted: tuple, key: tuple) -> SimpleNamespace:
    """A key's warm-up and capture for :func:`program`: the executable
    graph, its input buffers, its outputs in the graph's pool, the launches
    of the ``counted`` wrappers it holds, and what the capture cost."""
    global _BODIES, _KEEP, _READ_EXITS
    t0 = time.perf_counter()
    static = [t.clone() if _is_tensor(t) else t for t in leaves]
    bodies, keep = {}, []
    saved = (_BODIES, _KEEP, _READ_EXITS)
    _BODIES, _KEEP, _READ_EXITS = bodies, keep, False
    base = [w.launches for w in counted]
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(pytree.tree_unflatten(static, spec))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        r1 = torch.cuda.memory_reserved(dev)
        base = [w.launches for w in counted]     # the warm-up's launches ran
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            out = fn(pytree.tree_unflatten(static, spec))
        launches = tuple(w.launches - b for w, b in zip(counted, base))
    finally:
        _BODIES, _KEEP, _READ_EXITS = saved
        for w, b in zip(counted, base):
            w.launches = b                          # the capture launched nothing
    exec_ = ctypes.c_void_p()
    code = cuda_build.load().srba_graph_instantiate(graph.raw_cuda_graph(), ctypes.byref(exec_))
    if code != 0:
        raise RuntimeError(f"srba_graph_instantiate failed: cudaError {code}")
    outs, out_spec = pytree.tree_flatten(out)
    capture_s = time.perf_counter() - t0
    PROGRAM_STATS["captures"] += 1
    PROGRAM_STATS["capture_s"] += capture_s
    return SimpleNamespace(key=key, graph=graph, exec_=exec_, static=static, outs=outs,
                    out_spec=out_spec, counted=counted, launches=launches, bodies=bodies,
                    keep=keep, capture_s=capture_s, body_bytes=r1 - r0,
                    pool_bytes=torch.cuda.memory_reserved(dev) - r1)


def programs() -> list[dict]:
    """What each captured program holds and cost: its key, the launches of
    its counted wrappers, its captured steps, the host seconds of its
    warm-up and capture, and the device bytes its graph's pool and its
    steps' pools reserved."""
    return [dict(key=p.key, launches={w.__name__: n for w, n in zip(p.counted, p.launches)},
                 steps=len(p.bodies), capture_s=p.capture_s, pool_bytes=p.pool_bytes,
                 body_bytes=p.body_bytes) for p in _PROGRAMS.values()]
