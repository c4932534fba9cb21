"""The bench harness's full protocol with the eager scan and with the scan
graph, in turns (eager, graph, graph, eager), in one process on one card.

Each turn is ``bench.run()`` (5 / 8 / 2 repeats, every timed repeat gated
on the JAX run of its schedule) on the same rendered frames; the eager
turns set ``models/vo.py`` ``SCAN_GRAPHS`` off (the same bits). Prints each
turn's line and the numbers the scan graph should move. Run from the root
of the repository (~10 min on an H100):

    python -m srba_slam_tpu_torch.tools.scan_graph_ab

The busy shares after the first turn come from profiler sessions that
follow traces of graph scans (ROADMAP Queue 3): read them with that in mind.
"""

from __future__ import annotations

import json

from srba_slam_tpu_torch import bench
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.utils import bench_workload as bw


def summary(line: dict) -> str:
    """What a bench line says of the scan graph's effect."""
    lat = line["latency"]
    return (f"value {line['value']:.2f} fps, device_resident_fps "
            f"{line['device_resident_fps']:.2f}, bounded {lat['bounded_lag']['fps']:.2f}, "
            f"device-resident frame -> pose p50 "
            f"{lat[f'device_resident_batch{bw.DEV_CHUNK}']['frame_pose_p50_ms']:.1f} ms, "
            f"busy_share {line['busy_share']:.3f}, K1/K2 launches in the timed parts "
            f"{line['launches']['fast_nms']}/{line['launches']['orb_descriptors']}, scan graphs "
            f"{line['scan_graphs']}")


def main() -> int:
    frames = bench.render_frames()
    for name in ("eager", "graph", "graph", "eager"):
        vo.SCAN_GRAPHS = name == "graph"
        try:
            line = bench.run("cuda", frames=frames)
        finally:
            vo.SCAN_GRAPHS = True
        print(f"[harness {name}] {json.dumps(line)}")
        print(f"[harness {name}] {summary(line)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
