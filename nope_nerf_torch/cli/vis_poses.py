"""Pose-only visualization CLI: draw the learned camera trajectory as asymmetric
frustums. Port of nope_nerf_tpu/cli/vis_poses.py (the reference uses Open3D,
`vis/vis_poses.py:59-84` + `utils_poses/vis_cam_traj.py:31-62`; here the same
frustum geometry goes to an ASCII PLY line set in numpy, and to a matplotlib
3D figure where matplotlib is installed: it is imported inside draw_poses).

Usage: python -m nope_nerf_torch.cli.vis_poses <config.yaml> [--synthetic]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import DeviceLike, resolve_device


def frustum_lines(c2ws: np.ndarray, h: int, w: int, fx: float, fy: float,
                  frustum_length: float = 0.1) -> np.ndarray:
    """Per-camera frustum edges in world space, (N, 8, 2, 3) line segments.

    Asymmetric frustums (one corner cut) disambiguate orientation — the trick the
    reference uses (`vis_cam_traj.py:49-54`).
    """
    half_w = frustum_length * (w / 2.0) / fx
    half_h = frustum_length * (h / 2.0) / fy
    # OpenGL-style camera: looking along -z; one corner pulled in (asymmetry)
    corners = np.array([
        [-half_w, -half_h, -frustum_length],
        [half_w, -half_h, -frustum_length],
        [half_w, half_h, -frustum_length],
        [-half_w * 0.4, half_h, -frustum_length],  # cut corner
    ])
    origin = np.zeros(3)
    segs = []
    for c2w in c2ws:
        R, t = c2w[:3, :3], c2w[:3, 3]
        pts = corners @ R.T + t
        o = origin @ R.T + t
        cam_segs = [[o, p] for p in pts]
        cam_segs += [[pts[i], pts[(i + 1) % 4]] for i in range(4)]
        segs.append(cam_segs)
    return np.asarray(segs)


_PLY_COLORS = {"green": (0, 180, 0), "red": (220, 30, 30),
               "tab:blue": (31, 119, 180), "tab:orange": (255, 127, 14)}


def write_frustums_ply(c2ws_list, colors, h, w, fx, fy, out_path: str,
                       frustum_length: float = 0.1) -> str:
    """Exportable frustum + trajectory geometry as an ASCII PLY line set
    (vertex + edge elements, per-vertex color — loadable in MeshLab/Open3D).

    Information parity with the reference's interactive Open3D viewer
    (`utils_poses/vis_cam_traj.py:31-62`, `evaluation/eval_poses.py:166-315`):
    the same asymmetric frustum wireframes, minus the live window. The bytes
    equal the JAX package's for the same poses.
    """
    verts, vcols, edges = [], [], []
    for c2ws, color in zip(c2ws_list, colors):
        rgb = _PLY_COLORS.get(color, (128, 128, 128))
        segs = frustum_lines(np.asarray(c2ws), h, w, fx, fy,
                             frustum_length).reshape(-1, 2, 3)
        base = len(verts)
        for a, b in segs:
            verts += [a, b]
            vcols += [rgb, rgb]
        edges += [(base + 2 * i, base + 2 * i + 1) for i in range(len(segs))]
        t = np.asarray(c2ws)[:, :3, 3]  # trajectory polyline
        base = len(verts)
        verts += list(t)
        vcols += [rgb] * len(t)
        edges += [(base + i, base + i + 1) for i in range(len(t) - 1)]

    with open(out_path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                f"element edge {len(edges)}\n"
                "property int vertex1\nproperty int vertex2\n"
                "end_header\n")
        for v, c in zip(verts, vcols):
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")
    return out_path


def draw_poses(c2ws_list, colors, labels, h, w, fx, fy, out_path: str,
               frustum_length: float = 0.1) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    for c2ws, color, label in zip(c2ws_list, colors, labels):
        segs = frustum_lines(np.asarray(c2ws), h, w, fx, fy, frustum_length)
        ax.add_collection3d(Line3DCollection(segs.reshape(-1, 2, 3),
                                             colors=color, linewidths=0.8))
        t = np.asarray(c2ws)[:, :3, 3]
        ax.plot(*t.T, color=color, lw=1.0, label=label)
    allt = np.concatenate([np.asarray(c)[:, :3, 3] for c in c2ws_list])
    lo, hi = allt.min(0), allt.max(0)
    pad = 0.2 * max((hi - lo).max(), 1e-3)
    ax.set_xlim(lo[0] - pad, hi[0] + pad)
    ax.set_ylim(lo[1] - pad, hi[1] + pad)
    ax.set_zlim(lo[2] - pad, hi[2] + pad)
    ax.legend()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def visualize(cfg: dict, synthetic: bool = False, device: DeviceLike = None) -> str:
    """GT and learned (cfg's checkpoint, where there is one) frustums of cfg's
    scene to out_dir/poses_vis.png (with matplotlib) and poses_vis.ply;
    returns the figure's path."""
    import torch

    from ..data import DataField, SceneData, make_synthetic_scene
    from ..models.poses import pose_c2w_all
    from ..training import ModelConfigs, create_train_state
    from ..training.checkpoints import load_checkpoint

    dev = resolve_device(device)
    out_dir = cfg["training"]["out_dir"]
    if synthetic:
        scene = SceneData.from_dict(make_synthetic_scene(n_frames=8, h=120, w=160))
    else:
        scene = DataField.from_cfg(cfg, mode="train").scene
    mc = ModelConfigs.from_cfg(cfg, num_cams=scene.n_frames)
    state = create_train_state(
        0, mc, init_c2w=torch.as_tensor(scene.c2ws_gt) if cfg["pose"]["init_pose"] else None,
        device=dev)
    loaded = load_checkpoint(out_dir, cfg["training"]["load_dir"], state, load_model_only=True)
    trajs, colors, labels = [np.asarray(scene.c2ws_gt)], ["green"], ["GT"]
    if loaded is not None and mc.pose is not None:
        state, _ = loaded
        with torch.no_grad():
            trajs.append(pose_c2w_all(state.params["pose"], mc.pose).cpu().numpy())
        colors.append("red")
        labels.append("learned")

    h, w = scene.imgs.shape[1:3]
    fx = float(scene.K[0, 0]) * w / 2.0
    fy = float(-scene.K[1, 1]) * h / 2.0
    out_path = os.path.join(out_dir, "poses_vis.png")
    os.makedirs(out_dir, exist_ok=True)
    draw_poses(trajs, colors, labels, h, w, fx, fy, out_path)
    ply_path = write_frustums_ply(trajs, colors, h, w, fx, fy,
                                  os.path.join(out_dir, "poses_vis.ply"))
    print(f"saved {out_path} and {ply_path}")
    return out_path


def main():
    parser = argparse.ArgumentParser(description="Visualize camera pose frustums")
    parser.add_argument("config", nargs="?", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    args = parser.parse_args()
    from ..config import load_config
    cfg = load_config(args.config)
    visualize(cfg, synthetic=args.synthetic, device=args.device)


if __name__ == "__main__":
    main()
