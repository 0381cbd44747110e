"""Virtual KITTI ingestion CLI: builds an LLFF-format scene directory from raw
V-KITTI data and writes ready-to-train config yamls.

Port of nope_nerf_tpu/cli/get_vkitti.py (reference get_kittivirtual.py:16-331),
numpy and scipy only:
- frame selection by fixed interval or by motion (rotation / translation)
  thresholds against the ground-truth extrinsics;
- the V-KITTI intrinsics, copies of the images and 16-bit depth PNGs (read by
  data/image_io.py::read_png for the depth bounds);
- extrinsics -> c2w with the local x-axis flip (camera (right, down, forward)
  -> (right, up, backward)), the OpenGL world rotation and the inverse LLFF
  column permutation, as 17-float LLFF rows with per-frame depth bounds;
- train and preprocess yamls, the vanilla-NeRF simulation mode included.

The INFERNO disparity previews (`disp/`) need cv2's colour map and are
written only where cv2 is installed, as evaluation/artifacts.py does for its
disparity maps. The yamls go through the port's own emitter
(yaml_subset.dumps) on every machine: block YAML that config.py::load_config
and yaml.safe_load read back to the same dicts.

Usage:
  python -m nope_nerf_torch.cli.get_vkitti <root> <version> <id> <dest> <method> [...]
writes data/V_KITTI/<dest> and configs/V_KITTI/{<dest>,preprocess_<dest>}.yaml
under the working directory.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from .. import yaml_subset
from ..data.image_io import read_png

# V-KITTI intrinsics (reference get_kittivirtual.py:12-14)
K = np.array([[725, 0, 620.5],
              [0, 725, 187.0],
              [0, 0, 1]], np.float64)

# camera-local (right,down,forward) -> world (right,up,backward) change
P_GL = np.array([[0, 0, -1],
                 [0, -1, 0],
                 [-1, 0, 0]], np.float64)


def read_extrinsics(path: str) -> np.ndarray:
    """Parse the V-KITTI extrinsics txt: 'frame r1,1 ... r4,4' rows -> (N, 4, 4)."""
    rows = []
    with open(path) as f:
        f.readline()  # header
        for line in f:
            vals = line.split()
            if len(vals) < 17:
                continue
            rows.append(np.asarray(vals[1:17], np.float64).reshape(4, 4))
    return np.stack(rows)


def met_movement_thresholds(x, y, thresh_rot, thresh_translate) -> bool:
    """get_kittivirtual.py:16-30 (rotation-magnitude delta, translation delta)."""
    from scipy.spatial.transform import Rotation as R
    if thresh_rot is None and thresh_translate is None:
        return True
    d_rot = abs(R.from_matrix(x[:, :3]).magnitude() - R.from_matrix(y[:, :3]).magnitude())
    d_translate = np.linalg.norm(x[:, 3] - y[:, 3])
    if thresh_rot is not None and d_rot >= thresh_rot:
        return True
    if thresh_translate is not None and d_translate >= thresh_translate:
        return True
    return False


def get_filtered_ids(extrinsics: np.ndarray, method: str, start: int, end: int,
                     interval: int, thresh_rot, thresh_translate):
    """get_kittivirtual.py:36-64."""
    if method == "interval":
        return list(range(start, end, interval))
    ids = []
    previous = None
    step = 1
    for i in range(start, end):
        current = extrinsics[i][:3, :]
        if not ids:
            previous = current
            ids.append(i)
        elif met_movement_thresholds(current, previous, thresh_rot, thresh_translate):
            if step == interval:
                previous = current
                ids.append(i)
            else:
                step += 1
    return ids


def convert_pose(w2c: np.ndarray):
    """One extrinsics matrix -> (c2w_gl (4,4), llff c2w (4,4)).
    get_kittivirtual.py:136-162."""
    from scipy.spatial.transform import Rotation as R
    x = np.linalg.inv(w2c)
    r = x[:3, :3]
    t = x[:3, 3]
    # rotate about the local x axis: (right,down,forward) -> (right,up,backward)
    rot = R.from_rotvec(r[:, 0] * np.pi).as_matrix()
    r = rot @ r
    r_gl = np.linalg.inv(P_GL) @ r
    t_gl = np.linalg.inv(P_GL) @ t
    gl = np.eye(4)
    gl[:3, :3] = r_gl
    gl[:3, 3] = t_gl
    # inverse of the (x,y,z)->(y,-x,z) LLFF preprocessing permutation
    r_llff = np.hstack([-r_gl[:, 1:2], r_gl[:, 0:1], r_gl[:, 2:]])
    llff = np.eye(4)
    llff[:3, :3] = r_llff
    llff[:3, 3] = t_gl
    return gl, llff


def _write_disparity_previews(dest: str) -> None:
    """INFERNO disparity previews of the copied depths (get_kittivirtual.py:102-114),
    where cv2 is installed."""
    try:
        import cv2
    except ImportError:
        print("no cv2: no INFERNO disparity previews")
        return
    disp_dir = os.path.join(dest, "disp")
    os.makedirs(disp_dir, exist_ok=True)
    for name in sorted(os.listdir(os.path.join(dest, "depth"))):
        if not name.endswith(".png"):
            continue
        depth = read_png(os.path.join(dest, "depth", name))
        disp = 1.0 / np.maximum(depth.astype(np.float64), 1.0)
        disp8 = np.clip(255.0 / disp.max() * (disp - disp.min()), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(disp_dir, name),
                    cv2.applyColorMap(disp8, cv2.COLORMAP_INFERNO))


def build_scene(root: str, version: str, drive_id: str, variation: str, dest: str,
                frames, skip_copy: bool = False, make_gt: bool = False,
                make_colmap: bool = False):
    """Assemble the scene directory. Returns [height, width]."""
    os.makedirs(dest, exist_ok=True)
    np.savez(os.path.join(dest, "intrinsics.npz"), K=K)

    img_src = os.path.join(root, f"vkitti_{version}_rgb", drive_id, variation)
    depth_src = os.path.join(root, f"vkitti_{version}_depthgt", drive_id, variation)
    if not skip_copy:
        os.makedirs(os.path.join(dest, "images"), exist_ok=True)
        os.makedirs(os.path.join(dest, "depth"), exist_ok=True)
        for fr in frames:
            name = f"{str(fr).zfill(5)}.png"
            shutil.copy(os.path.join(img_src, name), os.path.join(dest, "images"))
            shutil.copy(os.path.join(depth_src, name), os.path.join(dest, "depth"))
    _write_disparity_previews(dest)

    # poses (get_kittivirtual.py:116-187)
    extr = read_extrinsics(os.path.join(root, f"vkitti_{version}_extrinsicsgt",
                                        f"{drive_id}_{variation}.txt"))
    rows = np.zeros((len(frames), 17))
    gl_all = np.zeros((len(frames), 4, 4))
    height = width = None
    for i, fr in enumerate(frames):
        gl, llff = convert_pose(extr[fr])
        gl_all[i] = gl
        depth = read_png(os.path.join(depth_src, f"{str(fr).zfill(5)}.png"))
        height, width = depth.shape
        depth_min = depth[depth > 0].min() / 100.0  # cm -> m
        depth_max = depth.max() / 100.0
        llff_35 = np.hstack([llff[:3, :], np.array([width, height, K[0, 0]]).reshape(3, 1)])
        rows[i] = np.hstack([llff_35.flatten(), depth_min, depth_max])

    if make_gt:
        np.savez(os.path.join(dest, "gt_poses.npz"), poses=gl_all)
    np.save(os.path.join(dest, "poses_gt.npy"), rows)
    if make_colmap:
        np.save(os.path.join(dest, "poses_bounds.npy"), rows)
    return [height, width]


def _write_yaml(path: str, data: dict) -> None:
    with open(path, "w") as f:
        f.write(yaml_subset.dumps(data))


def make_configs(dest: str, args, resolution, config_dir: str = "configs/V_KITTI"):
    """Write train and preprocess yamls (get_kittivirtual.py:189-270), layered
    over the in-code defaults rather than template files. Returns the train
    yaml's path."""
    path = os.path.normpath(os.path.join(dest, ".."))
    scene = os.path.basename(os.path.normpath(dest))
    os.makedirs(config_dir, exist_ok=True)

    common_dl = {
        "path": path, "scene": [scene],
        "resize_factor": args.resize_factor,
        "customized_poses": args.customised_poses,
        "customized_focal": args.customised_focal,
        "load_colmap_poses": args.load_colmap_poses,
    }
    preprocess = {"dataloading": {**common_dl, "depth_net": "dpt"},
                  "depth": {"type": "DPT"}}
    _write_yaml(os.path.join(config_dir, f"preprocess_{scene}.yaml"), preprocess)

    train = {
        "dataloading": {
            **common_dl,
            "with_depth": args.with_depth, "depth_scale": args.depth_scale,
            "sparsify_depth": args.sparsify_depth,
            "sparsify_depth_pattern": list(args.sparsify_depth_pattern),
            "noise_mean": args.noise_mean, "noise_std": args.noise_std,
            "offset_x": args.offset_x, "offset_y": args.offset_y,
        },
        "pose": {
            "learn_R": args.learn_pose, "learn_t": args.learn_pose,
            "init_pose": args.init_pose,
            "init_pose_type": "colmap" if args.load_colmap_poses else "gt",
            "init_R_only": False,
            "learn_focal": args.learn_focal, "update_focal": args.update_focal,
        },
        "distortion": {},
        "training": {
            "out_dir": os.path.join("out", "V_KITTI", scene),
            "depth_loss_type": args.depth_loss_type,
        },
        "extract_images": {
            "resolution": [int(np.ceil(x / args.resize_factor)) for x in resolution],
            "eval_depth": True,
            "traj_option": args.traj_option,
            "bspline_degree": args.bspline_degree,
        },
    }
    if not args.learn_pose:
        train["training"]["pc_weight"] = [0, 0]
        train["training"]["rgb_s_weight"] = [0, 0]
    if args.with_depth or not args.learn_distortion:
        train["distortion"]["learn_shift"] = False
        train["distortion"]["learn_scale"] = False
    if args.simulate_vanilla:  # get_kittivirtual.py:257-264
        train["pose"].update(init_pose=True, learn_R=False, learn_t=False,
                             learn_focal=False)
        train["training"].update(auto_scheduler=False, scheduling_start=0,
                                 annealing_epochs=0)

    train_yaml = os.path.join(config_dir, f"{scene}.yaml")
    _write_yaml(train_yaml, train)
    return train_yaml


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Build an LLFF scene directory from raw Virtual KITTI data")
    p.add_argument("root")
    p.add_argument("version")
    p.add_argument("id")
    p.add_argument("dest")
    p.add_argument("method", choices=["interval", "threshold"])
    p.add_argument("--variation", default="clone")
    p.add_argument("--skip-copy", action="store_true")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=None)
    p.add_argument("-i", "--interval", type=int, default=1)
    p.add_argument("-r", dest="thresh_rot", type=float, default=None)
    p.add_argument("-t", dest="thresh_translate", type=float, default=None)
    p.add_argument("--resize-factor", type=int, default=1)
    p.add_argument("--init-pose", action="store_true")
    p.add_argument("--learn-pose", type=bool, default=True)
    p.add_argument("--learn-focal", type=bool, default=False)
    p.add_argument("--learn-distortion", type=bool, default=True)
    p.add_argument("--load-colmap-poses", action="store_true")
    p.add_argument("--mock-colmap-poses", action="store_true")
    p.add_argument("--customised-poses", action="store_true")
    p.add_argument("--customised-focal", action="store_true")
    p.add_argument("--update-focal", default=True)
    p.add_argument("--with-depth", action="store_true")
    p.add_argument("--depth-scale", type=float, default=0.01)
    p.add_argument("--sparsify-depth", action="store_true")
    p.add_argument("--sparsify-depth-pattern", nargs=4, type=int, default=[1, 0, 1, 0])
    p.add_argument("--noise-mean", type=float, default=0)
    p.add_argument("--noise-std", type=float, default=0)
    p.add_argument("--offset-x", type=int, default=0)
    p.add_argument("--offset-y", type=int, default=0)
    p.add_argument("--traj-option", choices=["sprial", "spiral", "interp", "bspline"],
                   default="bspline")
    p.add_argument("--bspline-degree", type=int, default=100)
    p.add_argument("--depth-loss-type", choices=["l1", "invariant"], default="l1")
    p.add_argument("--simulate-vanilla", action="store_true")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    extr = read_extrinsics(os.path.join(
        args.root, f"vkitti_{args.version}_extrinsicsgt", f"{args.id}_{args.variation}.txt"))
    img_dir = os.path.join(args.root, f"vkitti_{args.version}_rgb", args.id, args.variation)
    end = args.end if args.end is not None else len(os.listdir(img_dir))
    frames = get_filtered_ids(extr, args.method, args.start, end, args.interval,
                              args.thresh_rot, args.thresh_translate)
    print(f"Got {len(frames)} frames")

    out_dir = os.path.join("data", "V_KITTI", args.dest)
    resolution = build_scene(args.root, args.version, args.id, args.variation, out_dir, frames,
                             args.skip_copy, make_gt=args.customised_poses,
                             make_colmap=args.mock_colmap_poses)
    train_yaml = make_configs(out_dir, args, resolution)
    print(f"Scene at {out_dir}; train config {train_yaml}")
    return out_dir, train_yaml


if __name__ == "__main__":
    main()
