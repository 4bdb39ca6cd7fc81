"""Single-ray 3D visualizer: the port of volume_path_tracer_tpu/tools/visualize_ray.py.

The reference renderer ships a second executable (src/ray_visualizer.cpp)
that draws every HDDA step and majorant segment of one camera ray as
wireframe cubes and line segments in an interactive raylib scene. Here the
same inspection renders to a matplotlib 3D figure (PNG), driven from the
scene config's single_pixel coordinate like the reference
(ray_visualizer.cpp:51-68).

Usage:
    python -m volume_path_tracer_tpu_torch.tools.visualize_ray scene.json out.png \
        [--procedural sphere|donut|plume] [--pixel X Y] [--cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def visualize_ray(medium, camera, params, bb_table, pixel_xy, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..grids.majorant import BRICK
    from .trace import majorant_segments, trace_path_events

    dev = medium.device
    x, y = pixel_xy
    o_w, d_w = camera.generate_rays(
        torch.tensor([[x, y]], dtype=torch.int32, device=dev),
        torch.zeros((1, 2), dtype=torch.float32, device=dev),
    )
    o_w, d_w = o_w[0].cpu().numpy(), d_w[0].cpu().numpy()

    segs = majorant_segments(medium, o_w, d_w)
    events = trace_path_events(medium, params, bb_table, o_w, d_w)

    g = medium.density

    def to_index(p_world):
        return g.world_to_index(torch.as_tensor(np.asarray(p_world), dtype=torch.float32)).numpy()

    o_i = to_index(o_w)

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    # Majorant segments as colored line pieces along the ray (index space).
    maxmaj = max((s[2] for s in segs), default=1.0) or 1.0
    for t0, t1, maj in segs:
        p0 = o_i + d_w * t0
        p1 = o_i + d_w * t1
        c = plt.cm.viridis(maj / maxmaj)
        ax.plot(*zip(p0, p1), color=c, linewidth=3 if maj > 0 else 1,
                alpha=1.0 if maj > 0 else 0.35)
        # brick wireframe at the segment start
        if maj > 0:
            lo = np.floor((p0 - np.asarray(g.origin_ijk)) / BRICK) * BRICK + np.asarray(g.origin_ijk)
            _draw_box(ax, lo, BRICK, color=c, alpha=0.25)

    # Path events
    for e in events:
        if e["kind"] in ("sampled_point", "shadow_point"):
            ax.scatter(*to_index(e["point"]),
                       color="red" if e["kind"] == "sampled_point" else "orange", s=14)
        elif e["kind"] == "scatter":
            ax.scatter(*to_index(e["point"]), color="lime", s=40, marker="*")

    ax.set_title(
        f"ray @ pixel {pixel_xy}: {len(segs)} segments, "
        f"{sum(1 for e in events if e['kind']=='sampled_point')} collisions"
    )
    ax.set_xlabel("i"); ax.set_ylabel("j"); ax.set_zlabel("k")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return segs, events


def _draw_box(ax, lo, size, color, alpha=0.3):
    import itertools

    lo = np.asarray(lo, float)
    for a, b in itertools.combinations(range(8), 2):
        pa = lo + size * np.array([(a >> 2) & 1, (a >> 1) & 1, a & 1])
        pb = lo + size * np.array([(b >> 2) & 1, (b >> 1) & 1, b & 1])
        if np.sum(pa != pb) == 1:  # box edge
            ax.plot(*zip(pa, pb), color=color, alpha=alpha, linewidth=0.6)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="visualize_ray")
    ap.add_argument("config")
    ap.add_argument("output", nargs="?", default="ray.png")
    ap.add_argument("--procedural", choices=["donut", "sphere", "plume"], default=None)
    ap.add_argument("--pixel", type=int, nargs=2, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..cli import _load_medium
    from ..models.camera import Camera
    from ..render.integrator import IntegratorParams
    from ..render.renderer import _bb_table_for
    from ..utils.config import read_configuration
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = read_configuration(args.config)
    medium = _load_medium(cfg, args.procedural, device)
    camera = Camera.from_parameters(cfg.camera_parameters, cfg.output_size, device=device)
    params = IntegratorParams.from_config(
        cfg.volume_parameters, cfg.worker_parameters
    )
    pixel = tuple(args.pixel) if args.pixel else tuple(
        cfg.worker_parameters.single_pixel.coord
    )
    segs, events = visualize_ray(
        medium, camera, params, _bb_table_for(medium, params), pixel, args.output
    )
    print(f"[visualize_ray] {len(segs)} majorant segments, "
          f"{len(events)} events -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
