"""Run one cell of the benchmark once and print its result line.

    python3 -m slam_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell
(``BENCHMARK.json``: a configuration and a traffic mix) is found by name
(``spec.py``). A run:

1. set-up (``setup_s``, from the process's start to the window's): checks
   the card, loads the deployment's vocabulary (``vocab.py``, built and
   cached at the first run in a checkout), renders the log from ``--seed``
   on the card (a straight street, or the configuration's ``circuit``
   driven in laps) and keeps it in pinned host memory (``render.py``), then
   runs one throwaway session of the cell's own traffic over the first
   ``warmup_frames`` frames of the log (to its end, ``finalize`` included,
   where the log is no longer), so that every shape-keyed program the
   window meets is captured before it;
2. the window: fresh sessions of the traffic back to back, each a new
   estimator on the shared vocabulary replaying the log from its first
   frame, until ``--seconds`` have passed. ``entry: batched`` hands frames
   to ``perform_stereo_slam_batched`` as its loop asks, stopping at a batch
   boundary once the time is up, then lands the solves (``rba.flush()``)
   and, at a log's end, runs ``finalize()``; ``entry: step`` calls
   ``step(left, right)`` frame after frame, timing each call. Frames are
   handed over as the loop asks (a closed loop), or, where the traffic
   gives ``rate_hz``, no earlier than their arrival at that rate from the
   session's start (an open loop; a step's time then counts from the
   frame's arrival). ``fps`` is every frame whose pose was read over the
   whole window (session starts and epilogues included);
   ``frame_pose_p95_ms`` the 95th percentile of every step of the window;
3. with ``--trace 1``, the per-layer metrics from the instruments of
   ``trace.py`` and the kernels' rooflines (``roofline.py``), each read by
   its reader in ``metrics/`` from the run's record (its counts, its
   per-frame times, the tracer and its spans);
4. the check (``correct.py``): the frames, keyframe checks and window
   solves drawn from the seed (and every window with loop-closure checks),
   worked out again by the plain reference once the program's state is
   freed; on a circuit, each session's standing edges against the
   ground-truth poses.

The last line on stdout is the result; the numbers compared are the last
lines on stderr and the line's last key, ``checks``. No card, fewer cards
than the cell asks for, a missing program, or the JAX package or jax
loaded in this process: exit 2 and no line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slam_bench import correct, spec, stats  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "srba_slam_tpu")
OUT_DIR = os.path.join(spec.HERE, "_cache", "out")


class Refused(RuntimeError):
    """A run that must print no result."""


def log(msg: str):
    print(f"slam_bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``srba_slam_tpu_torch`` is not ``srba_slam_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# ----------------------------------------------------------------- the system
class System:
    """The program under test, built from one configuration."""

    def __init__(self, config: dict, vocabulary: dict, device):
        from srba_slam_tpu_torch.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
        from srba_slam_tpu_torch.models.bow import Vocabulary
        from srba_slam_tpu_torch.utils.camera import StereoCamera

        self.config, self.device = config, device
        bits, weights = vocabulary["leaf_bits"], vocabulary["weights"]
        n = bits.shape[0]
        pad = (max(n, 128) + 127) // 128 * 128
        self.voc = Vocabulary(np.concatenate([bits, np.zeros((pad - n, 256), np.int8)]),
                              np.concatenate([weights, np.zeros(pad - n, np.float32)]),
                              n, vocabulary["k"], vocabulary["L"])
        cam = StereoCamera(**config["camera"])
        self._general = GeneralOptions(out_dir=OUT_DIR, verbose_level=0)
        self._opts = SRBAStereoSLAMOptions(camera=cam, camera_dist_l=list(config["dist_l"]),
                                           camera_dist_r=list(config["dist_r"]),
                                           **config["options"])
        self._vo = VOOptions(**config["vo_options"])

    def session(self):
        """A new estimator: a new map on the shared vocabulary."""
        from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator

        est = SRBAStereoSLAMEstimator(copy.deepcopy(self._general), copy.deepcopy(self._opts),
                                      copy.deepcopy(self._vo), capacity=self.config["capacity"],
                                      max_kfs=self.config["max_kfs"], device=self.device)
        est.initialize(vocabulary=self.voc)
        return est


# -------------------------------------------------------------------- traffic
def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warmup_frames(frames: int, n_log: int, batch: int) -> int:
    """At most ``frames`` of the log, so that the batched loop's last batch
    (after the first frame, which goes alone) is as long as the whole
    log's: its scan program is then captured in the warm-up."""
    if frames >= n_log:
        return n_log
    tail = (n_log - 1) % batch
    w = 1 + (max(frames - 1, 0) // batch) * batch + tail
    return w if w <= n_log else n_log


def warm_pose_graph(est, n_walked: int, n_log: int):
    """Capture the pose-graph program at the padded sizes that a whole log
    is expected to reach (the warm-up's keyframes and edges scaled to the
    log's length), on the warm-up's own graph padded to them, as
    ``finalize`` pads its graph. A capture takes seconds, so only the
    predicted sizes are warmed; a log that ends elsewhere captures in the
    window, where ``capture_s_in_window`` shows it."""
    from srba_slam_tpu_torch.ops import cuda_graphs
    from srba_slam_tpu_torch.ops.posegraph import optimize_pose_graph

    n = est.store.n_kfs
    est.rba.flush()
    if n < 2 or not est.rba.n_edges:
        return []

    def pads(count: float) -> set:
        return {max(64, 1 << (max(int(count), 2) - 1).bit_length())}

    eu, ev, rel = est.rba.get_global_graphslam_problem()
    scale = n_log / max(n_walked, 1)
    done = []
    for n_pad in sorted(pads(n * scale)):
        for e_pad in sorted(pads(len(eu) * scale)):
            if n_pad < n or e_pad < len(eu):
                continue
            done.append((n_pad, e_pad))
            eu_a = np.zeros(e_pad, np.int32); eu_a[:len(eu)] = eu
            ev_a = np.zeros(e_pad, np.int32); ev_a[:len(ev)] = ev
            rel_a = np.zeros((e_pad, 6), np.float32); rel_a[:len(eu)] = rel
            e_valid = np.zeros(e_pad, bool); e_valid[:len(eu)] = True
            poses0 = np.zeros((n_pad, 6), np.float32)
            poses0[:n] = est.rba.kf_global[:n]
            dev = est.device
            optimize_pose_graph(*(cuda_graphs.upload(a, dev) for a in
                                  (poses0, np.arange(n_pad) < n, eu_a, ev_a, rel_a, e_valid)),
                                max_iters=25, host_edges=(eu_a, ev_a, e_valid))
    _sync(est.device)
    return done


def drive(system: System, traffic: dict, lefts, rights, deadline: float, frames: int,
          recorder=None, until_log_end: bool = False, keep_last: bool = False) -> dict:
    """Sessions of ``traffic`` over the first ``frames`` frames of the log,
    back to back until ``deadline`` (a host clock), or one session when
    ``until_log_end``. Returns the counts and per-frame times."""
    n_log = lefts.shape[0]
    frames = min(frames, n_log)
    L, R = lefts.numpy(), rights.numpy()
    entry, batch = traffic["entry"], int(traffic.get("batch", 1))
    rate = traffic.get("rate_hz")
    out = dict(walked=0, handed=0, sessions=0, logs_ended=0, step_ms=[], quiet_ms=[],
               finalize_ms=[], kfs=0, checks=0, vo_valid=0, lat=[], step_logs=[])
    session = 0
    while True:
        if recorder is not None:
            recorder.session = session
        est = system.session()
        handed = [0]
        t_session = time.perf_counter()

        def arrival(f: int) -> float:
            """When frame ``f`` is there to hand over: now in a closed loop,
            at ``f / rate_hz`` from the session's start in an open one."""
            if rate is None:
                return time.perf_counter()
            due = t_session + f / float(rate)
            while time.perf_counter() < due:
                time.sleep(min(due - time.perf_counter(), 0.002))
            return due

        if entry == "batched":
            def source(handed=handed):
                # a session hands over its first frame and first batch
                # whatever the clock says: the batched loop needs a frame
                # after the first (on a card it raises without one, §7)
                for f in range(frames):
                    if (not until_log_end and f > batch and (f - 1) % batch == 0
                            and time.perf_counter() >= deadline):
                        return
                    arrival(f)
                    handed[0] += 1
                    yield L[f], R[f]

            est.perform_stereo_slam_batched(source(), batch=batch)
        elif entry == "step":
            for f in range(frames):
                if not until_log_end and time.perf_counter() >= deadline:
                    break
                if recorder is not None:
                    recorder.frame = f
                t0 = arrival(f)
                res = est.step(L[f], R[f])
                ms = (time.perf_counter() - t0) * 1e3
                handed[0] += 1
                out["step_ms"].append(ms)
                if not res.kf_check and res.inserted_kf is None:
                    out["quiet_ms"].append(ms)
        else:
            raise ValueError(f"traffic entry {entry!r}: not 'batched' or 'step'")
        est.rba.flush()
        ended = handed[0] == n_log
        if recorder is not None:
            recorder.session_end(est, ended)
        if ended and traffic.get("finalize", False):
            _sync(system.device)
            t0 = time.perf_counter()
            est.finalize()
            _sync(system.device)
            out["finalize_ms"].append((time.perf_counter() - t0) * 1e3)
        _sync(system.device)
        out["walked"] += len(est.step_log)
        out["handed"] += handed[0]
        out["kfs"] += sum(r.inserted_kf is not None for r in est.step_log)
        out["checks"] += sum(bool(r.kf_check) for r in est.step_log)
        out["vo_valid"] += sum(bool(r.vo_valid) for r in est.step_log)
        out["logs_ended"] += int(ended)
        out["lat"].append(est.lat)
        out["step_logs"].append(est.step_log)
        out["sessions"] += 1
        session += 1
        if until_log_end or time.perf_counter() >= deadline:
            if keep_last:
                out["last"] = est
            return out
        del est


# ------------------------------------------------------------------------ run
def eyes(config: dict):
    from slam_bench import render

    c = config["camera"]
    raw = not config["vo_options"].get("rectified_images", True)
    dl = tuple(config["dist_l"]) if raw else (0.0,) * 5
    dr = tuple(config["dist_r"]) if raw else (0.0,) * 5
    return (render.Camera(c["fx_l"], c["fy_l"], c["cx_l"], c["cy_l"], c["width"], c["height"], dl),
            render.Camera(c["fx_r"], c["fy_r"], c["cx_r"], c["cy_r"], c["width"], c["height"], dr))


def scan_images(config: dict, traffic: dict, lefts, rights, device) -> torch.Tensor:
    """The frames one scan of the cell hands K1 and K2: a batch's left and
    right images as the program sees them (remapped to f32 for a raw rig)."""
    from slam_bench.reference import frontend

    b = int(traffic.get("batch", 1))
    imgs = torch.cat([lefts[1:1 + b], rights[1:1 + b]]).to(device)
    if config["vo_options"].get("rectified_images", True):
        return imgs
    s = correct.Setup(config, device)
    return torch.cat([frontend.remap_bilinear(imgs[:b], s.maps[0]),
                      frontend.remap_bilinear(imgs[b:], s.maps[1])])


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
        control_dtype=None, t_start: float = T_START, share: float = correct.SHARE,
        sample: int | None = None) -> dict:
    from slam_bench import render, vocab

    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    torch.empty(0, device=device)
    log(f"device ready ({time.perf_counter() - t_start:.3f} s since start)")
    voc, built = vocab.load_or_build(config["vocabulary"], device)
    log(f"vocabulary: {voc['leaf_bits'].shape[0]} words ({'built' if built else 'cached'}; "
        f"{time.perf_counter() - t_start:.3f} s since start)")
    system = System(config, voc, device)
    lg = config["log"]
    drv = render.Drive(eyes(config), config["camera"]["baseline"], lg["frames"], seed,
                       lg["step_m"], device=device, circuit=lg.get("circuit"))
    lefts, rights = render.render_log(drv)
    # the ground truth, which judges loop closures on a circuit
    poses = drv.poses
    del drv
    log(f"log: {lefts.shape[0]} frames {tuple(lefts.shape[1:])} rendered "
        f"({time.perf_counter() - t_start:.3f} s since start)")
    # the warm-up: one session of the cell's own traffic, over a prefix of
    # the log whose last batch is as long as the log's last batch
    n_log = lefts.shape[0]
    n_warm = warmup_frames(int(config["log"]["warmup_frames"]), n_log,
                           int(traffic.get("batch", 1)))
    warm = drive(system, traffic, lefts, rights, 0.0, n_warm, until_log_end=True,
                 keep_last=True)
    est_w = warm.pop("last")
    if device.type == "cuda":
        from srba_slam_tpu_torch.ops import cuda_graphs

        log("warm-up captures by kind (count, s): " + ", ".join(
            f"{k} {v['captures']} {v['capture_s']:.3f}" for k, v in cuda_graphs.KIND_STATS.items()))
    log(f"warm-up session done ({time.perf_counter() - t_start:.3f} s since start)")
    if traffic.get("finalize", False) and n_warm < n_log and device.type == "cuda":
        pads = warm_pose_graph(est_w, n_warm, n_log)
        log(f"pose graph warmed at (nodes, edges) {pads} "
            f"({time.perf_counter() - t_start:.3f} s since start)")
    del est_w
    gc.collect()
    _sync(device)
    if device.type == "cuda":
        from srba_slam_tpu_torch.ops import cuda_graphs

        cuda_graphs.release_dropped()
        torch.cuda.reset_peak_memory_stats(device)
        kinds0 = {k: v["capture_s"] for k, v in cuda_graphs.KIND_STATS.items()}
    log(f"warm-up: {warm['walked']} of {warm['handed']} frames, {warm['kfs']} keyframes, "
        f"{warm['checks']} checks, {warm['vo_valid']} valid VO poses "
        f"({time.perf_counter() - t_start:.3f} s since start)")
    recorder = correct.Recorder(seed, share=share, keep_db=sample is not None,
                                keep_checks=max(correct.CHECK_KEEP, sample or 0),
                                poses=poses if lg.get("circuit") else None)
    recorder.install()
    tracer = None
    if trace:
        from slam_bench import trace as trace_mod

        tracer = trace_mod.Tracer()
        tracer.install()
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    try:
        win = drive(system, traffic, lefts, rights, t0 + seconds, lefts.shape[0], recorder)
        _sync(device)
        window_s = time.perf_counter() - t0
    finally:
        if tracer is not None:
            tracer.uninstall()
        recorder.uninstall()
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of the JAX stack are loaded: {found}")
    peak = 0
    capture_s = 0.0
    if device.type == "cuda":
        # what the window holds: set-up (rendering, the warm-up, a first
        # run's vocabulary build) is left out by the reset above
        peak = torch.cuda.max_memory_allocated(device)
        by_kind = {k: v["capture_s"] - kinds0.get(k, 0.0) for k, v in cuda_graphs.KIND_STATS.items()}
        capture_s = sum(by_kind.values())
        log("captures in the window by kind, s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in by_kind.items() if v > 0))
    metrics = {}
    e2e = {m["name"]: m for m in cell.end_to_end}
    if "fps" in e2e:
        metrics["fps"] = dict(value=win["walked"] / window_s, unit=e2e["fps"]["unit"])
    if "frame_pose_p95_ms" in e2e:
        metrics["frame_pose_p95_ms"] = dict(value=stats.percentile(win["step_ms"], 0.95),
                                            unit=e2e["frame_pose_p95_ms"]["unit"])
    metrics["setup_s"] = dict(value=setup_s, unit=e2e["setup_s"]["unit"])
    log(f"window: {window_s:.3f} s, {win['walked']} frames in {win['sessions']} sessions "
        f"({win['logs_ended']} logs ended), {win['kfs']} keyframes, {win['checks']} checks, "
        f"{win['vo_valid']} frames with a valid VO pose; "
        f"setup {setup_s:.3f} s; captures in the window {capture_s:.3f} s")
    line = dict(correct=False, attempted=win["handed"], failed=win["handed"] - win["walked"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=int(peak))
    if trace:
        _sync(device)
        spans = tracer.timeline()
        window_ms = window_s * 1e3
        busy_ms = stats.covered([(max(a, 0.0), min(b, window_ms)) for _k, a, b in spans])
        # what a reader in metrics/ reads: the run's counts and times, its
        # whole record (``run``: per session the estimator's host stamps
        # ``lat`` and its ``step_log``), the tracer with its device spans
        t = dict(cell=cell.name, frames=win["walked"], kfs=win["kfs"], checks=win["checks"],
                 window_s=window_s, syncs=tracer.syncs, capture_s=capture_s,
                 finalize_ms=win["finalize_ms"], quiet_ms=win["quiet_ms"],
                 vo_ms=tracer.device_ms(spans, trace_mod.VO_KINDS),
                 check_ms=tracer.device_ms(spans, trace_mod.CHECK_KINDS),
                 window_ms=tracer.device_ms(spans, trace_mod.WINDOW_KINDS),
                 busy_s=busy_ms / 1e3, peak_window_bytes=peak,
                 entry=traffic["entry"], run=win, tracer=tracer, spans=spans)
        if device.type == "cuda":
            from slam_bench import roofline

            imgs = scan_images(config, traffic, lefts, rights, device)
            t["kernels"] = roofline.kernel_shares(imgs, config["options"]["detect_fast_th"],
                                                  config["capacity"])
        per_layer = {}
        for entry, reader in cell.per_layer:
            v = reader.read(t)
            if v is not None:
                per_layer[entry["name"]] = dict(value=float(v), unit=entry["unit"])
        metrics = per_layer
        dev.update(busy_s=busy_ms / 1e3, window_s=window_s)
        line["breakdown"] = tracer.breakdown(spans, window_ms)
        del tracer
    # the check, once the program's state is freed
    rng = np.random.default_rng([seed, 11])
    cases = recorder.cases(rng, sample)
    del recorder, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    setup = correct.Setup(config, device, voc)
    numbers = correct.compare(cases, setup, lefts, rights)
    log(f"windows with loop-closure checks: {cases['lc_windows_met']} met, "
        f"{numbers['lc_windows']} compared; buckets compared (C, L, O, loop): "
        f"{[(*w['key'], bool(w.get('lc'))) for w in cases['windows']]}")
    if "edges" in numbers:
        log(f"edges standing at the sessions' ends: {numbers['edges']}; loop edges by session "
            f"{numbers['loop_edges_by_session']!r}; gap to the ground truth by kind "
            f"{numbers['edge_gap_by_kind']!r}; widest (m, rad, session, kind, loop, keyframes, "
            f"frames): {numbers['edge_widest']!r}")
    correct.dump_widest(numbers, os.path.join(OUT_DIR, f"widest_frame_{seed}.json"))
    for msg in correct.dump_windows(numbers, config["limits"]["window_cost_excess"],
                                    os.path.join(OUT_DIR, f"window_{seed}_")):
        log(msg)
    if control_dtype is not None:
        # the program's own reading beside the control's, for the limits
        ok, checks = correct.verdict(numbers, config["limits"])
        for name, v in numbers.items():
            if isinstance(v, (int, float)):
                log(f"program {name} {v!r}")
        log(f"program widest frame: {json.dumps(numbers['widest_frame'])}")
        log(f"program widest check: {json.dumps(numbers.get('widest_check'))}")
        numbers = correct.compare(cases, setup, lefts, rights, control_dtype)
    ok, checks = correct.verdict(numbers, config["limits"])
    log("not compared: " + ", ".join(f"{k} {numbers[k]!r}" for k in (
        "pose_widest_gap_m", "pose_widest_gap_rad", "window_pose_gap_m", "window_pose_gap_rad",
        "window_cost_shortfall")))
    line.update(correct=ok, metrics=metrics, device=dev)
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the reference in bfloat16 in the program's place (calibration only)")
    ap.add_argument("--sample", type=int, default=None,
                    help="compare this many cases of each kind (calibration only)")
    args = ap.parse_args(argv)
    try:
        cell = spec.cell(args.workload)
        if not torch.cuda.is_available():
            raise Refused("no CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} cards, the cell asks for {cell.chips}")
        try:
            import srba_slam_tpu_torch  # noqa: F401
        except ImportError as e:
            raise Refused(f"the program is not here: {e}") from e
        line = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   torch.bfloat16 if args.control else None,
                   share=correct.SHARE if args.sample is None else 0.25, sample=args.sample)
        found = forbidden_modules()
        if found:
            raise Refused(f"modules of the JAX stack are loaded: {found}")
    except (Refused, FileNotFoundError, KeyError) as e:
        log(f"refused: {e}")
        return 2
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
