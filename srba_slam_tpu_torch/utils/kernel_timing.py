"""Device-only kernel times and roofline bounds on one H100.

``graph_ms`` captures ``reps`` calls of a wrapper in a CUDA graph and
replays it between two CUDA events, so the time is the card's alone: the
wrapper's host work (checks, ``torch.empty``, the ctypes call) runs once, at
capture. ``profiler_kernel_us`` reads the same kernel's duration from
``torch.profiler`` as a cross-check (None where no trace held it).
``launch_floor_ms`` is ``graph_ms`` of
an empty kernel (``csrc/fast_score.cu`` ``empty_kernel``) at a given grid
and block: what the launch alone costs the card. ``bound_ms`` is the least
time the card could take for given bytes and f32 operations, at the
published peaks of an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the
tensor cores).

Nothing here runs at import; every function needs a CUDA card.
"""

from __future__ import annotations

import statistics

import torch

from srba_slam_tpu_torch.ops import cuda_build
from srba_slam_tpu_torch.parallel.batch import canonical_device

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
PROFILE_ATTEMPTS = 3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, reps: int = 100, replays: int = 5, device=None) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph after 3 warm-up calls, the median of ``replays`` timed replays
    divided by ``reps``. ``fn``'s inputs stay fixed and live on ``device``
    (the current device by default); the warm-up, the capture, the replays
    and the events run on its current stream."""
    dev = canonical_device("cuda" if device is None else device)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):  # a capture stream on ``dev``
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        del graph
    return statistics.median(times)


def launch_floor_ms(grid: tuple[int, int, int], block: tuple[int, int, int],
                    device=None) -> float:
    """Device ms of one launch of an empty kernel on ``grid`` blocks of
    ``block`` threads on ``device`` (the current device by default),
    captured and replayed as ``graph_ms`` does."""
    lib = cuda_build.load()
    dev = canonical_device("cuda" if device is None else device)

    def launch():
        code = lib.srba_empty_launch(*grid, *block, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {code}")

    return graph_ms(launch, device=dev)


def profile_calls(fn, reps: int = 1, cuda_only: bool = False):
    """``torch.profiler`` key averages over ``reps`` calls of ``fn`` (after
    one warm-up call), CPU and CUDA activity (CUDA only with ``cuda_only``:
    the runtime API's launches and the device's records, no operator
    events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_events(evs):
    return [e for e in evs if e.device_type.name == "CUDA"]


def launch_count(evs) -> int:
    """Kernel launches the host made (runtime and driver API)."""
    return sum(e.count for e in evs
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                            "cuLaunchKernelEx"))


def profile_until(fn, names, reps: int = 1, attempts: int = PROFILE_ATTEMPTS):
    """``profile_calls`` again until the trace holds a device kernel whose
    name contains each of ``names``, at most ``attempts`` times: a
    torch.profiler trace on an H100 has missed a kernel that ran. The key
    averages of the first such trace, or None if no attempt traced them all."""
    for _ in range(attempts):
        evs = profile_calls(fn, reps)
        dev = device_events(evs)
        if all(any(name in e.key for e in dev) for name in names):
            return evs
    return None


def profiler_kernel_us(fn, name: str, reps: int = 20) -> float | None:
    """Mean device µs of the kernels whose name contains ``name`` over
    ``reps`` calls of ``fn``, from ``torch.profiler``; None if no trace of
    ``profile_until`` held such a kernel."""
    evs = profile_until(fn, (name,), reps)
    if evs is None:
        return None
    evs = [e for e in device_events(evs) if name in e.key]
    return sum(e.self_device_time_total for e in evs) / sum(e.count for e in evs)
