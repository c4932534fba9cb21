"""CLI app shell (≙ src/srba-stereo-slam_main.cpp).

Usage::

    python -m srba_slam_tpu_torch <config.ini> [--synthetic N] [--checkpoint path]
                                  [--resume path] [--gt file] [--serve [PORT]]
                                  [--batch B] [--fleet S] [--cpu] [--trace FILE]

Counterpart of ``python -m srba_slam_tpu``: the same arguments and the same
flow. It takes the reference's ``.ini`` config format unmodified (the demo
configs load as they are). ``--synthetic N`` replaces the image source with
an N-frame rendered sequence for dataset-free runs. The run is on the CUDA
card unless ``--cpu`` is given. ``--batch B`` runs the VO of B frames as
one batched scan (default: 8 on the card, frame by frame on the CPU);
``--fleet S`` with ``--synthetic`` runs S independent rendered sequences in
lockstep (``parallel/fleet.py``), sharded over the device mesh (the
largest count of the machine's cards that divides S), their outputs under
``<out_dir>/seq<i>/``. ``--trace FILE`` records the run's trace
(``ops/cuda_graphs.py`` ``record_spans``: host spans, program replays and
eager groups on the card, one axis) and writes it to FILE as Chrome
trace-event JSON (chrome://tracing, Perfetto), each span with its frame.
"""

from __future__ import annotations

import argparse
import sys
import time

TAG = "[srba_slam_tpu_torch]"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="srba_slam_tpu_torch")
    ap.add_argument("config", help=".ini configuration (reference format)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="use an N-frame synthetic rendered sequence")
    ap.add_argument("--checkpoint", default="", help="save state here at the end")
    ap.add_argument("--resume", default="", help="restore state before running")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="frames per batched VO scan (0 = auto: 8 on the card, "
                         "frame by frame with --cpu; 1 = frame by frame)")
    ap.add_argument("--gt", "--eval", dest="gt", default="", metavar="FILE",
                    help="ground-truth trajectory (KITTI poses.txt, "
                         "out_kf_poses.txt format, or Nx3 xyz) to report "
                         "ATE RMSE against after the run; to evaluate an "
                         "EXISTING trajectory without re-running, use "
                         "python -m srba_slam_tpu_torch.utils.evaluation")
    ap.add_argument("--fleet", type=int, default=0, metavar="S",
                    help="with --synthetic: run S independent sequences in "
                         "lockstep, sharded over the device mesh "
                         "(parallel.fleet); per-sequence outputs land in "
                         "<out_dir>/seq<i>/")
    ap.add_argument("--serve", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve a LIVE interactive map viewer over HTTP "
                         "(stdlib server rooted at <out_dir>; PORT omitted "
                         "= ephemeral). Browser equivalent of the "
                         "reference's live 3D window; implies show3D-style "
                         "per-keyframe snapshots")
    ap.add_argument("--trace", default="", metavar="FILE",
                    help="record the run's trace and write it to FILE as Chrome "
                         "trace-event JSON (host spans and device spans, one clock)")
    args = ap.parse_args(argv)
    if not args.trace:
        return _session(args)

    import torch

    from srba_slam_tpu_torch.ops import cuda_graphs

    with cuda_graphs.record_spans() as tr:
        rc = _session(args)
    if tr.anchor is not None:
        torch.cuda.synchronize()      # the device events' times are read now
    tr.write_chrome(args.trace)
    print(f"{TAG} trace: {len(tr.host)} host spans, {len(tr.replays)} program replays "
          f"-> {args.trace}")
    return rc


def _session(args) -> int:
    """The run of ``main``'s parsed arguments."""
    import torch

    from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
    from srba_slam_tpu_torch.utils.framesource import ImageDirSource, SyntheticSource

    device = "cpu" if args.cpu else "cuda"
    est = SRBAStereoSLAMEstimator.from_config(args.config, device=device)
    est.initialize()
    backend = "cpu" if args.cpu else f"cuda ({torch.cuda.get_device_name(est.device)})"
    print(f"{TAG} backend: {backend}", flush=True)

    srv = None
    if args.serve is not None:
        from srba_slam_tpu_torch.utils.live_server import start_live_server

        # live snapshots ride the show3D hook (per-keyframe live_map.png/json)
        est.general.show3D = True
        srv, port = start_live_server(est.general.out_dir or "out", args.serve)
        print(f"{TAG} live map viewer: http://localhost:{port}/", flush=True)
    if est.general.verbose_level >= 1:
        from srba_slam_tpu_torch.config import dump_options

        print(dump_options(est.general, est.opts, est.vo_opts))
        if (est.general.pause_after_show_op
                or est.opts.pause_after_show_op) and sys.stdin is not None \
                and sys.stdin.isatty():
            # ≙ pause_after_show_op -> system::pause() after the option
            # dumps (reference utils.h:213, :482)
            input("Press <enter> to continue...")

    # config-driven state restore (≙ load_state_from_file/state_file,
    # reference utils.h:103-104,157-165; the mutual exclusion with
    # save_state_to_file is applied at config load); the CLI --resume flag
    # takes precedence
    resume_path = args.resume or (
        est.general.state_file
        if est.general.load_state_from_file and est.general.state_file
        else "")
    if resume_path:
        from srba_slam_tpu_torch.utils.checkpoint import load_state

        load_state(est, resume_path)
        print(f"{TAG} resumed from {resume_path} ({est.store.n_kfs} KFs)")

    if args.fleet:
        return _fleet(args, est, device)

    if args.synthetic:
        source = SyntheticSource(est.cam, n_frames=args.synthetic, step=0.5)
    elif est.general.cap_src == "rawlog" or (
            est.general.rawlog_file and est.general.cap_src != "image_dir"):
        # ≙ the reference's CCameraSensor rawlog grabber
        # (src/CSRBAStereoSLAMEstimator.cpp:1194-1197, srba-stereo-slam_utils.h:96-101).
        # The MRPT binary rawlog format is not supported: reject loudly
        # instead of silently ignoring the config key.
        print(
            f"{TAG} error: grabber_type=rawlog is not supported "
            f"(rawlog_file={est.general.rawlog_file!r}); export the rawlog "
            "to an image directory (e.g. mrpt's rawlog-edit "
            "--externalize/--extract-images) and use grabber_type=image_dir",
            file=sys.stderr,
        )
        return 2
    else:
        from srba_slam_tpu_torch.native.loader import NativeImageDirSource

        if NativeImageDirSource.available():
            g = est.general
            source = NativeImageDirSource(
                g.image_dir_url, g.left_format, g.right_format,
                g.start_index, g.end_index,
            )
        else:
            # g++ or libpng is missing: the pure-Python loader, same bytes
            source = ImageDirSource.from_options(est.general)
        print(f"{TAG} frame loader: {type(source).__name__}", flush=True)

    if est.general.save_state_to_file and est.general.save_at_iteration > 0:
        # ≙ save_at_iteration (reference utils.h:94, .cpp:223-235: "save
        # state and exit" at iteration N): truncate the run at that frame;
        # the end-of-run save below persists the state
        import itertools

        source = itertools.islice(
            iter(source), est.general.save_at_iteration)
        print(f"{TAG} will stop and save state at iteration "
              f"{est.general.save_at_iteration}")

    batch = args.batch
    if batch == 0:
        batch = 1 if args.cpu else 8
    if est.general.pause_at_each_iteration:
        # interactive per-frame pausing needs per-frame stepping (≙ reference
        # .cpp:934-935, a per-iteration pause)
        batch = 1
    t0 = time.time()
    if batch > 1:
        log = est.perform_stereo_slam_batched(source, batch=batch)
    else:
        log = est.perform_stereo_slam(source)
    dt = time.time() - t0
    n = len(log)
    print(f"{TAG} {n} frames, {est.store.n_kfs} keyframes, "
          f"{n / max(dt, 1e-9):.2f} fps")

    out_dir = est.general.out_dir or "out"
    poses = est.finalize(out_dir=out_dir)
    print(f"{TAG} outputs written to {out_dir}/")

    if args.gt:
        from srba_slam_tpu_torch.utils.evaluation import ate_rmse, load_gt

        gt_xyz, per_frame = load_gt(args.gt)
        if per_frame:
            # associate each KEYFRAME with the ground-truth row of the frame
            # it was inserted at
            kf_frames = [r.frame_idx for r in log if r.inserted_kf is not None]
            kf_frames = [f for f in kf_frames if f < len(gt_xyz)]
            est_xyz = poses[: len(kf_frames), 3:]
            gt_sel = gt_xyz[kf_frames]
        else:
            n = min(len(gt_xyz), len(poses))
            est_xyz, gt_sel = poses[:n, 3:], gt_xyz[:n]
        if len(est_xyz) >= 3:
            rmse = ate_rmse(est_xyz, gt_sel)
            print(f"{TAG} ATE RMSE vs {args.gt}: {rmse:.4f} m "
                  f"({len(est_xyz)} keyframes, SE(3)-aligned)")
        else:
            print(f"{TAG} --gt: fewer than 3 associated poses; "
                  "no ATE computed")
    if est.general.enable_logger:
        print(est.profiler.summary())

    # config-driven state save (≙ save_state_to_file/state_file,
    # reference utils.h:103-104,157-165); --checkpoint takes precedence
    save_path = args.checkpoint or (
        est.general.state_file
        if est.general.save_state_to_file and est.general.state_file
        else "")
    if save_path:
        est.save_checkpoint(save_path)
        print(f"{TAG} state saved to {save_path}")
    return 0


def _fleet(args, est, device) -> int:
    """``--fleet S``: S independent rendered sequences (seeds 11 + 37 i) in
    lockstep over JAX's default mesh of the machine's cards (``--cpu``: the
    CPU), each estimator built on its shard's device and ``est`` the first;
    one vocabulary for all; the outputs of sequence i in
    ``<out_dir>/seq<i>/``."""
    import os

    from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
    from srba_slam_tpu_torch.parallel.batch import fleet_mesh
    from srba_slam_tpu_torch.parallel.fleet import FleetSLAM
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource

    if not args.synthetic:
        print(f"{TAG} error: --fleet requires --synthetic N (multi-directory image "
              "fleets are not wired to the CLI)", file=sys.stderr)
        return 2
    mesh = fleet_mesh(args.fleet, est.device)
    per = args.fleet // len(mesh.devices)
    ests = [est] + [SRBAStereoSLAMEstimator.from_config(args.config, device=mesh.devices[i // per])
                    for i in range(1, args.fleet)]
    voc = est.bow.voc if est.bow is not None else None
    if voc is None:
        # no vocabulary file in the config: train one shared vocabulary from
        # the first voc_train_frames frames of sequence 0, on a scratch
        # estimator
        scratch = SRBAStereoSLAMEstimator.from_config(args.config, device=device)
        scratch.initialize()
        n_train = max(1, scratch.opts.voc_train_frames)
        for left, right in SyntheticSource(scratch.cam, n_frames=n_train, step=0.5, seed=11):
            scratch.step(left, right)
        scratch.ensure_vocabulary()
        voc = scratch.bow.voc
        est.initialize(vocabulary=voc)
    for e in ests[1:]:
        e.initialize(vocabulary=voc)
    sources = [SyntheticSource(e.cam, n_frames=args.synthetic, step=0.5, seed=11 + 37 * i)
               for i, e in enumerate(ests)]
    fleet = FleetSLAM(ests, mesh)
    t0 = time.time()
    fleet.run(sources)
    dt = time.time() - t0
    n_frames = sum(e.frame_idx + 1 for e in ests)
    print(f"{TAG} fleet: {len(ests)} sequences x {args.synthetic} frames on a "
          f"{len(mesh.devices)}-device mesh, {n_frames / max(dt, 1e-9):.2f} frames/s aggregate")
    out_dir = est.general.out_dir or "out"
    for i, e in enumerate(ests):
        e.finalize(out_dir=os.path.join(out_dir, f"seq{i}"))
        print(f"{TAG}   seq{i}: {e.store.n_kfs} keyframes -> {out_dir}/seq{i}/")
    return 0


def run(argv=None) -> int:
    """``main`` behind the top-level catch (≙ the reference's main()
    try/except, src/srba-stereo-slam_main.cpp:66-75): exit codes 1 for a
    missing file or any other failure, 130 for an interrupt. Mid-run
    pipeline failures have already saved their artifacts through the
    estimator's emergency epilogue."""
    try:
        return main(argv)
    except FileNotFoundError as e:
        print(f"{TAG} error: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        print(f"{TAG} interrupted", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001
        import traceback

        traceback.print_exc()
        print(f"{TAG} fatal: {type(e).__name__}: {e} "
              "(crash artifacts, if any, are under <out_dir>/crash/)",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
