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
batch's VO scan, ``models/vo.py`` ``vo_scan``; a frame's frontend and its
tracking in per-frame stepping, ``models/vo.py`` ``extract_and_match``
and ``solve_tracks``; a keyframe check and the loop-closure re-check,
``models/data_association.py``; a row write of the keyframe store or the
BoW database and the database's rebuild, ``models/keyframe.py`` and
``models/bow.py``; a fleet shard's lockstep attempt and check
group, ``parallel/fleet.py``, and a shard's batched VO step,
``parallel/batch.py``; a group of window solves, ``ops/window_ba.py``
``solve_window_group``; the pose graph, ``ops/posegraph.py``; a sharded
window's shard and lead steps, ``ops/window_ba.py``) as one CUDA graph
per key, as the JAX package jits it once per shape: its inputs are
copied into fixed buffers (from any device; a solve's fixed inputs only
when they change),
the tensors it holds (a check's keyframe store and BoW database, written
in place, and its vocabulary; a row write's store or database) are read
and written where they are, the
graph replays, and its outputs are cloned out. A program that holds
tensors lives no longer than they do: once one of them is freed, the
program leaves the cache, and its graphs and their memory pools are freed
at the next safe point (:func:`release_dropped`). A program that holds
nothing (a scan, a frame's frontend without rectification maps, a track,
an attempt, a batched step, a window-solve group, the pose graph) is keyed
by shapes and options only and stays for the life of
the process, as the JAX package's jit cache does. Inside that capture
``loop`` appends its steps to the graph as the same WHILE node
(``csrc/graph_cond.cu`` ``srba_cond_append``; a carry without ``more``
runs its n steps): the steps that the eager launches run, the same bits.
A program keeps its own captured steps (captured in its warm-up), so no
other caller of a step's key shares its buffers. A capture or an append
that fails raises; nothing falls back to the eager launches.

:func:`record_spans` (``utils/trace.py``) records the port's trace: the
device spans of :func:`span`, timed with CUDA events and no CUPTI (the
bench harness's busy share), each program replay named by its key
(:func:`program`), a ``capture`` host span for each capture, an ``upload``
span for each :func:`upload`.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import time
import weakref
from types import SimpleNamespace

import numpy as np
import torch
from torch.utils import _pytree as pytree

from srba_slam_tpu_torch.ops import cuda_build
from srba_slam_tpu_torch.utils import trace
from srba_slam_tpu_torch.utils.trace import record_spans  # noqa: F401  (the trace's switch)

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
# Programs whose held tensors were freed: out of _PROGRAMS, their graphs
# not yet freed (release_dropped)
_DROPPED: list = []
# Tells a program from a later one captured under the same key
_TOKENS = itertools.count()
# Over the process: programs captured, and the host seconds of their
# warm-ups and captures; the same by kind (a key's first element: "vo_scan",
# "frame", "track", "check", "recheck", "kf_row", "bow_row", "bow_rebuild",
# "fleet_attempt", "fleet_check", "batched_step", "window_group",
# "posegraph", "window_shard")
PROGRAM_STATS = dict(captures=0, capture_s=0.0)
KIND_STATS: dict = {}


# Whether a device span is open (an inner span is part of the outer one)
_SPAN_OPEN = False


def span(kind: str, device):
    """A span of device work on ``device``'s current stream, recorded
    inside :func:`record_spans` (and not inside another span, a program's
    warm-up or a capture): a graph launch with its input copies and output
    clones (``kind="graph"``: the card's time for it, copies included), or
    a group of eager launches (``"eager"``: from the card reaching its first
    launch to its last kernel's end, so it holds any wait for the host's
    next launch; an upper bound of the group's kernel time). Yields its
    ``(start, end)`` events, or None where it records none."""
    if trace.ACTIVE is None:
        return trace.NOOP
    return _span(kind, device)


@contextlib.contextmanager
def _span(kind: str, device):
    global _SPAN_OPEN
    tr, device = trace.ACTIVE, torch.device(device)
    if (_SPAN_OPEN or device.type != "cuda" or in_program()
            or torch.cuda.is_current_stream_capturing()):
        yield None
        return
    stream = torch.cuda.current_stream(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(stream)
    _SPAN_OPEN = True
    try:
        yield start, end
    finally:
        _SPAN_OPEN = False
        end.record(stream)
        tr.append((kind, start, end))


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


def stop(i: int, c: dict) -> bool:
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
        if stop(i, c):
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
    (at most ``n`` steps, counted in a buffer of the program). A carry
    without ``more`` (the Horn seed's fixed Jacobi sweeps) runs its ``n``
    steps: the node's flag is a buffer of the program that the graph sets
    True before the node, so it counts to ``n``."""
    if "more" in sc:
        pred = sc["more"]
    else:
        pred = torch.ones((), dtype=torch.bool, device=dev)   # a fill kernel in the graph
        _KEEP.append(pred)
    count = torch.empty((), dtype=torch.int32, device=dev)
    _KEEP.append(count)
    code = cuda_build.load().srba_cond_append(torch.cuda.current_stream(dev).cuda_stream,
                                              graph.raw_cuda_graph(), pred.data_ptr(),
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

    launch.execs = execs          # freed with a dropped program (_release)
    return launch


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _kind(key: tuple):
    return key[0] if isinstance(key, tuple) and key else None


def capture_stats(kind: str) -> dict:
    """Programs of one kind (a key's first element, as ``KIND_STATS`` lists
    them) captured so far and the host seconds of their warm-ups and
    captures."""
    stats = KIND_STATS.get(kind, {})
    return dict(captures=stats.get("captures", 0), capture_s=stats.get("capture_s", 0.0))


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves if _is_tensor(t))


def _storage(x):
    """A held leaf in a program's key: a tensor by its address, shape,
    strides and dtype (a tensor put in its place captures anew)."""
    if not _is_tensor(x):
        return x
    return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)


def upload(rows, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host data (nested lists of numbers, or an array) as one tensor on
    ``device``: one copy, from pinned memory and ``non_blocking`` on a card,
    so the host does not wait for the card (a pageable copy would
    synchronize it); a program's device inputs."""
    device = torch.device(device)
    with trace.span("upload") as sp:
        host = torch.as_tensor(rows, dtype=dtype)
        if device.type == "cuda":
            host = host.pin_memory()     # a copy: torch pins no tensor made from numpy
        if sp is not None:
            sp.nbytes = host.numel() * host.element_size()
        return host.to(device, non_blocking=True)


_ALIGN = 8   # bytes: the widest element a packed buffer holds (int64)


def pack(arrays) -> tuple[np.ndarray, tuple]:
    """Host arrays of any dtypes as one uint8 array (each at an offset
    aligned to 8 bytes), for one :func:`upload` of them all; and the layout
    that :func:`unpack` reads them back with: (offset, dtype, shape) each."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    layout, off = [], 0
    for a in arrays:
        layout.append((off, torch.from_numpy(a[:0].reshape(-1)).dtype, a.shape))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = np.zeros(off, np.uint8)
    for a, (o, _dt, _shape) in zip(arrays, layout):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf, tuple(layout)


def unpack(buf: torch.Tensor, layout: tuple) -> list[torch.Tensor]:
    """The arrays of :func:`pack` as views of ``buf`` (its upload): no copy,
    no kernel."""
    out = []
    for off, dtype, shape in layout:
        size = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        out.append(buf[off:off + size].view(dtype).reshape(shape))
    return out


def upload_arrays(arrays, device) -> list[torch.Tensor]:
    """Host arrays of any dtypes on ``device`` in one :func:`upload` of
    their :func:`pack`: views of one buffer, each contiguous (a program's
    input copies them in as copies, with no kernel)."""
    buf, layout = pack(arrays)
    return unpack(upload(buf, device), layout)


def _shapes(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) if _is_tensor(t) else t for t in leaves)


def program_key(inputs: dict, key: tuple, held: dict | None = None, fixed: dict | None = None,
                device=None) -> tuple:
    """The key under which :func:`program` keeps the program of ``fn(inputs)``
    (and the program's device: ``device``, else the inputs'): ``key``, the
    device, the inputs' and the fixed inputs' structure, shapes and dtypes
    (their non-tensor leaves as they are), and the held tensors' structure,
    addresses, shapes, strides and dtypes."""
    leaves, spec = pytree.tree_flatten(inputs)
    f_leaves, f_spec = pytree.tree_flatten(fixed or {})
    h_leaves, h_spec = pytree.tree_flatten(held or {})
    dev = (torch.device(device) if device is not None else
           next(t for t in leaves + f_leaves + h_leaves if _is_tensor(t)).device)
    return (key, repr(spec), dev, _shapes(leaves), repr(f_spec), _shapes(f_leaves),
            repr(h_spec), tuple(_storage(t) for t in h_leaves)), dev


def _get(fn, inputs: dict, key: tuple, counted, held: dict, fixed: dict, device):
    """The program of ``fn(inputs)`` under ``key``, captured now unless
    cached; with the inputs' leaves, the fixed inputs' leaves, the
    program's device, and whether it was captured now."""
    leaves, spec = pytree.tree_flatten(inputs)
    f_leaves, f_spec = pytree.tree_flatten(fixed)
    full_key, dev = program_key(inputs, key, held, fixed, device)
    prog = _PROGRAMS.get(full_key)
    fresh = prog is None
    if fresh:
        with trace.span("capture", site=key), torch.cuda.device(dev):
            prog = _capture(fn, (leaves, spec), (f_leaves, f_spec), held, dev, tuple(counted),
                            key)
        _register(full_key, prog, pytree.tree_leaves(held))
    return prog, leaves, f_leaves, dev, fresh


def _copied_from(leaves) -> list:
    """What :func:`program` remembers of the fixed inputs it copied in: each
    tensor (weakly) and its version counter."""
    return [(weakref.ref(t), t._version) if _is_tensor(t) else None for t in leaves]


def _same_fixed(prog: SimpleNamespace, leaves) -> bool:
    """Whether ``leaves`` are the very tensors whose bits the program's
    fixed buffers hold: the same objects, not written in place since."""
    return len(prog.fixed_from) == len(leaves) and all(
        r is None or (r[0]() is t and r[1] == t._version)
        for r, t in zip(prog.fixed_from, leaves))


def _register(full_key: tuple, prog: SimpleNamespace, held_leaves) -> None:
    """Cache ``prog`` under ``full_key``, dropped (:func:`_drop`) once any
    of the tensors it holds is freed. The held leaves are the owners'
    long-lived tensors (a store's arrays, a database, a vocabulary), never
    views made for the call: a view would be freed, and its program
    dropped, as soon as the call returns."""
    prog.token = next(_TOKENS)
    _PROGRAMS[full_key] = prog
    for t in held_leaves:
        if _is_tensor(t):
            weakref.finalize(t, _drop, full_key, prog.token).atexit = False


def _drop(full_key: tuple, token: int) -> None:
    """A held tensor of the program ``token`` was freed: the program leaves
    the cache (a tensor later made at the same address captures anew). Runs
    inside the garbage collector, maybe during another program's capture,
    so it makes no CUDA call: :func:`release_dropped` frees its graphs."""
    prog = _PROGRAMS.get(full_key)
    if prog is not None and prog.token == token:
        del _PROGRAMS[full_key]
        _DROPPED.append(prog)


def release_dropped() -> int:
    """Free the graphs of the dropped programs: synchronize each one's
    device, destroy its executable graphs (its own and its loops'), reset
    its CUDA graphs and let go of its buffers, so that its pools go back to
    the allocator (``torch.cuda.empty_cache`` returns them to the card).
    Called where no capture runs: before a capture (which synchronizes
    anyway), by :func:`programs` and :func:`live_programs`. Returns the
    number freed."""
    if not _DROPPED or torch.cuda.is_current_stream_capturing():
        return 0
    dropped = list(_DROPPED)
    _DROPPED.clear()
    for prog in dropped:
        _release(prog)
    return len(dropped)


def _release(prog: SimpleNamespace) -> None:
    lib = cuda_build.load()
    torch.cuda.synchronize(prog.dev)
    for graph, launch, _sc, _sk in prog.bodies.values():
        for exec_ in (launch.execs.values() if launch is not None else ()):
            lib.srba_graph_exec_destroy(exec_)
        graph.reset()
    lib.srba_graph_exec_destroy(prog.exec_)
    prog.graph.reset()
    prog.bodies, prog.keep, prog.outs, prog.static, prog.fixed = {}, [], [], [], []


def program(fn, inputs: dict, key: tuple, counted=(), held: dict | None = None,
            fixed: dict | None = None, device=None):
    """``fn(inputs)`` on a card as one replay of a CUDA graph captured at
    the first call of ``key`` and of the inputs' shapes and dtypes.

    ``inputs`` is a dict of tensors on one CUDA device (or nests of them in
    tuples, named tuples and dicts, as ``torch.utils._pytree`` flattens
    them; any other leaf, such as None, is part of the key and stays as it
    is); ``fn`` returns such a nest. Each call copies the inputs into the program's buffers, launches
    the graph on the current stream and returns clones of its outputs
    (made contiguous in the graph, so a clone is a copy), so a later call
    does not overwrite what an earlier one returned. ``key``
    holds everything else that ``fn`` bakes into its kernels (shapes it
    derives, options, Python numbers). ``counted`` are kernel wrappers with
    a ``launches`` count (``ops/hopper_fast.py``): a capture does not add
    to them, each replay adds the launches that the graph holds.

    ``held`` (a dict, flattened as ``inputs``) are tensors the graph reads
    and writes where they are, never copied: ``fn`` gets them beside the
    inputs (``fn({**inputs, **held})``, the names distinct). Their
    addresses, shapes, strides and dtypes join the key, so a held tensor
    that another takes the place of captures anew; the program keeps no
    reference to them, and is dropped once one of them is freed
    (:func:`_register`). A key's first call runs ``fn`` on them twice (the
    warm-up, then the replay), so what ``fn`` writes there must not depend
    on what it wrote before. A keyframe check holds the keyframe store and
    the BoW database (its row written in place, as JAX donates them, before
    it reads the rows under it) and the vocabulary.

    ``fixed`` (a dict, flattened as ``inputs``) are inputs copied into
    buffers of the program like ``inputs``, but only when they are other
    tensors than at the program's last call, or were written in place
    since (their version counters): a solve's observations and gather
    tables, copied in once for the many replays of its LM iterations, not
    once a replay. Their shapes and dtypes join the key, not their
    addresses. A fixed input must not be written by anything that leaves
    its version counter as it is (a graph replay) while a program may still
    read it; ``fn`` gets it beside the inputs and must not write it.

    ``device`` is the program's device (by default the inputs'). An input
    on another device is copied into the program's buffer across devices:
    torch orders such a copy after the work queued on the source's current
    stream, and the program's stream after the copy, with events, so one
    device's programs feed another's with no host synchronization (a
    sharded window's shards and its lead, ``ops/window_ba.py``).

    A key's first call runs ``fn`` once eagerly on the buffers (the warm-up:
    it captures its loops' steps, each once, into the program's own cache,
    and sets up library handles), then captures ``fn`` with its loops as
    conditional nodes (:func:`loop`), without reading an exit test on the
    host. A capture that fails raises.

    Inside :func:`record_spans` a call that replayed (and is not inside
    another program's warm-up or capture) is recorded as a replay of its
    kind and key (``utils/trace.py``), with the events of its ``"graph"``
    span."""
    t0 = trace.stamp()
    if t0 is not None and (in_program() or torch.cuda.is_current_stream_capturing()):
        t0 = None
    held = held or {}
    fixed = fixed or {}
    prog, leaves, f_leaves, dev, fresh = _get(fn, inputs, key, counted, held, fixed, device)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        with span("graph", dev) as events:
            for d, s_ in zip(prog.static, leaves):
                if _is_tensor(d):
                    d.copy_(s_)
            if not _same_fixed(prog, f_leaves):
                for d, s_ in zip(prog.fixed, f_leaves):
                    if _is_tensor(d):
                        d.copy_(s_)
                prog.fixed_from = _copied_from(f_leaves)
            code = lib.srba_graph_launch(prog.exec_, torch.cuda.current_stream(dev).cuda_stream)
            if code != 0:
                raise RuntimeError(f"srba_graph_launch failed: cudaError {code}")
            outs = [t.clone() if _is_tensor(t) else t for t in prog.outs]
        for wrapper, n in zip(prog.counted, prog.launches):
            wrapper.launches += n
        out = pytree.tree_unflatten(outs, prog.out_spec)
        if t0 is not None and not fresh:
            trace.replay(t0, key, events)
        return out


def capture(fn, inputs: dict, key: tuple, counted=(), held: dict | None = None,
            fixed: dict | None = None, device=None) -> bool:
    """The program of ``program(fn, inputs, key, counted, held, fixed,
    device)`` captured now unless it is cached, without a replay (its
    warm-up runs ``fn`` once on copies of the inputs, its outputs dropped).
    True if it was captured now: a caller captures ahead of the timed part
    of a run."""
    return _get(fn, inputs, key, counted, held or {}, fixed or {}, device)[4]


def _buffers(leaves, dev) -> list:
    """Copies of ``leaves`` on ``dev``: a program's input buffers."""
    return [t.to(dev, copy=True) if _is_tensor(t) else t for t in leaves]


def _capture(fn, flat: tuple, f_flat: tuple, held: dict, dev, counted: tuple,
             key: tuple) -> SimpleNamespace:
    """A key's warm-up and capture for :func:`program` (``flat`` and
    ``f_flat`` the inputs' and the fixed inputs' leaves and structure): the
    executable graph, its input buffers, its outputs in the graph's pool,
    the launches of the ``counted`` wrappers it holds, and what the warm-up
    and the capture cost."""
    global _BODIES, _KEEP, _READ_EXITS
    t0 = time.perf_counter()
    (leaves, spec), (f_leaves, f_spec) = flat, f_flat
    static, fixed = _buffers(leaves, dev), _buffers(f_leaves, dev)

    def args():
        return {**pytree.tree_unflatten(static, spec), **pytree.tree_unflatten(fixed, f_spec),
                **held}
    bodies, keep = {}, []
    saved = (_BODIES, _KEEP, _READ_EXITS)
    _BODIES, _KEEP, _READ_EXITS = bodies, keep, False
    base = [w.launches for w in counted]
    try:
        torch.cuda.synchronize(dev)
        release_dropped()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(args())
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        r1 = torch.cuda.memory_reserved(dev)
        t1 = time.perf_counter()
        base = [w.launches for w in counted]     # the warm-up's launches ran
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            out = fn(args())
            # outputs dense in the pool: a replay clones them with copies,
            # where a strided view's clone would launch a kernel
            out = pytree.tree_map(lambda t: t.contiguous() if _is_tensor(t) else t, out)
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
    for stats in (PROGRAM_STATS, KIND_STATS.setdefault(_kind(key), dict(captures=0,
                                                                         capture_s=0.0))):
        stats["captures"] += 1
        stats["capture_s"] += capture_s
    return SimpleNamespace(key=key, dev=dev, graph=graph, exec_=exec_, static=static, fixed=fixed,
                           fixed_from=_copied_from(f_leaves), outs=outs, out_spec=out_spec,
                           counted=counted, launches=launches, bodies=bodies, keep=keep,
                           capture_s=capture_s, warmup_s=t1 - t0, body_bytes=r1 - r0,
                           pool_bytes=torch.cuda.memory_reserved(dev) - r1,
                           copy_bytes=_nbytes(static) + _nbytes(outs),
                           fixed_bytes=_nbytes(fixed),
                           held_bytes=_nbytes(pytree.tree_leaves(held)))


def programs() -> list[dict]:
    """What each live program holds and cost (the dropped ones freed
    first): its key, its token (which capture made it), the launches of
    its counted wrappers, its captured
    steps, the host seconds of its warm-up and capture (``warmup_s`` of
    them the warm-up), the device bytes its graph's pool and its steps'
    pools reserved, the bytes a replay copies (its inputs in, its outputs
    cloned out), the bytes of its fixed inputs' buffers (copied in when
    they change) and the bytes of the tensors it holds in place."""
    release_dropped()
    return [dict(key=p.key, token=p.token,
                 launches={w.__name__: n for w, n in zip(p.counted, p.launches)},
                 steps=len(p.bodies), capture_s=p.capture_s, warmup_s=p.warmup_s,
                 pool_bytes=p.pool_bytes, body_bytes=p.body_bytes, copy_bytes=p.copy_bytes,
                 fixed_bytes=p.fixed_bytes, held_bytes=p.held_bytes)
            for p in _PROGRAMS.values()]


def live_programs() -> dict:
    """The live programs by kind (a key's first element), the dropped ones
    freed first."""
    release_dropped()
    counts: dict = {}
    for p in _PROGRAMS.values():
        counts[_kind(p.key)] = counts.get(_kind(p.key), 0) + 1
    return counts
