"""The traced run's instruments, all from the benchmark's own files.

While installed, :class:`Tracer` wraps from the outside:

* ``ops/cuda_graphs.py`` ``program``: each replay of a program between two
  CUDA events on the current stream, named by its kind (the first element
  of its key: ``vo_scan``, ``frame``, ``track``, ``check``, ``window_group``,
  ``posegraph``, ...). A call that captured its program is kept apart (its
  span holds the host's capture). Nothing is recorded inside another
  program's warm-up or capture;
* ``cuda_graphs.record_spans``: the port's own spans of its eager groups
  (a scan's summary, a read of the host), an upper bound of their device
  time;
* the estimator's host layers (a step, a scan's dispatch and its walk, the
  checks, an insertion, the window groups' dispatch, ``finalize``), as host
  clock intervals, to name what the host was doing in each idle gap;
* torch's ``set_sync_debug_mode("warn")``: each host synchronization warns
  once, and the warnings are counted.

All device spans are placed on one timeline by a start event recorded,
with the host clock beside it, on an idle card when the window opens.
"""

from __future__ import annotations

import time
import warnings

import torch

from slam_bench import stats

VO_KINDS = ("vo_scan", "frame", "track")
CHECK_KINDS = ("check",)
WINDOW_KINDS = ("window_group", "window_shard")
HOST_LAYERS = (
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator", "step", "step"),
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator", "_dispatch_scan",
     "scan dispatch"),
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator", "_process_scan",
     "batch walk"),
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator", "_kf_check", "check"),
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator",
     "_dispatch_planned_checks", "check"),
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator", "_kf_apply", "insertion"),
    ("srba_slam_tpu_torch.models.srba", "SRBAEngine", "_dispatch_queued", "window dispatch"),
    ("srba_slam_tpu_torch.models.estimator", "SRBAStereoSLAMEstimator", "finalize", "finalize"),
)


class Tracer:
    def __init__(self):
        self.programs: list = []      # (kind, start event, end event)
        self.captured: list = []      # kinds whose call captured inside the window
        self.host: list = []          # (name, t0, t1, depth) host clock
        self.syncs = 0
        self._depth = 0
        self._undo = []

    # ------------------------------------------------------------ install
    def install(self):
        import importlib

        from srba_slam_tpu_torch.ops import cuda_graphs

        tr = self
        orig_program = cuda_graphs.program

        def program(fn, inputs, key, *a, **kw):
            if cuda_graphs.in_program() or torch.cuda.is_current_stream_capturing():
                return orig_program(fn, inputs, key, *a, **kw)
            kind = key[0] if isinstance(key, tuple) and key else str(key)
            n0 = cuda_graphs.PROGRAM_STATS["captures"]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = orig_program(fn, inputs, key, *a, **kw)
            end.record()
            if cuda_graphs.PROGRAM_STATS["captures"] != n0:
                tr.captured.append(kind)
            else:
                tr.programs.append((kind, start, end))
            return out

        cuda_graphs.program = program
        self._undo.append((cuda_graphs, "program", orig_program))
        for mod_name, cls_name, meth, label in HOST_LAYERS:
            owner = getattr(importlib.import_module(mod_name), cls_name)
            orig = getattr(owner, meth)
            setattr(owner, meth, self._host_wrap(orig, label))
            self._undo.append((owner, meth, orig))
        self._spans_cm = cuda_graphs.record_spans()
        self.eager = self._spans_cm.__enter__()
        self._warn_cm = warnings.catch_warnings()
        self._warn_cm.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, *args, **kwargs):
            if "synchroniz" in str(message):
                tr.syncs += 1
            else:
                shown(message, category, *args, **kwargs)

        warnings.showwarning = show
        torch.cuda.synchronize()
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()
        self.t_ref = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")

    def _host_wrap(self, fn, label):
        tr = self

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            tr._depth += 1
            try:
                return fn(*a, **kw)
            finally:
                tr._depth -= 1
                tr.host.append((label, t0, time.perf_counter(), tr._depth))

        wrapped.__wrapped__ = fn
        return wrapped

    def uninstall(self):
        torch.cuda.set_sync_debug_mode("default")
        self._warn_cm.__exit__(None, None, None)
        self._spans_cm.__exit__(None, None, None)
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []

    # ------------------------------------------------------------- read
    def timeline(self):
        """Named device spans (kind, start ms, end ms) after ``ref``: the
        programs' and the eager groups'. Call after a synchronize."""
        out = [(k, self.ref.elapsed_time(a), self.ref.elapsed_time(b)) for k, a, b in self.programs]
        out += [("eager", self.ref.elapsed_time(a), self.ref.elapsed_time(b))
                for k, a, b in self.eager if k == "eager"]
        return out

    def device_ms(self, spans, kinds) -> list[float]:
        return [b - a for k, a, b in spans if k in kinds]

    def host_at(self, t_host: float) -> str:
        """The innermost host layer open at ``t_host``, else the harness's
        own loop (the frame source and the session's bookkeeping)."""
        best, depth = "harness loop", -1
        for name, t0, t1, d in self.host:
            if t0 <= t_host < t1 and d > depth:
                best, depth = name, d
        return best

    def breakdown(self, spans, window_ms: float) -> dict:
        by_kind: dict = {}
        for k, a, b in spans:
            by_kind[k] = by_kind.get(k, 0.0) + (b - a) / 1e3
        ops = sorted(by_kind.items(), key=lambda kv: -kv[1])[:10]
        gap_s: dict = {}
        for a, b in stats.gaps([(a, b) for _k, a, b in spans], 0.0, window_ms):
            name = self.host_at(self.t_ref + a / 1e3)
            gap_s[name] = gap_s.get(name, 0.0) + (b - a) / 1e3
        idle = sorted(gap_s.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=[[k, v] for k, v in idle])
