"""The README's full-length system checks through the port's entry points,
each command a subprocess as a user would type it, with its wall time.

- drive: scripts.make_demo_scene, then cli.train configs/demo_drive.yaml in
  stages (--max-epochs 1000, 2000, 3000 by default: each resumes from the
  checkpoint), then cli.eval_poses --vis, cli.eval and cli.render;
- vk: the same scene at 188x621 (make_demo_scene --dest data/demo_vk/drive
  --height 188 --width 621) and configs/demo_drive_vk.yaml for 1000 epochs;
- joint: scripts.demo_joint_pose_training from identity poses for the 31,000
  steps of the JAX package's run on the same 8-frame 120x160 synthetic scene
  (README.md:45-47), 3875 epochs of 8 frames.

The commands run in --work (the yamls' relative data/ and out/ land there);
each one's output goes to <logs>/<protocol>_<step>.log as it runs. The noised
init's ATE is computed from the scene on disk (COLMAP-stand-in poses against
GT, as cli.eval_poses computes a checkpoint's). The parsed numbers, beside the
JAX package's quality numbers from README.md / BASELINE.md (a TPU run of the
JAX package) and the verdict of the rule below, go to <logs>/summary.json
after every step and to the last line of output.

A port run misses when its held-out PSNR is more than 1.0 dB below the JAX
number, its final ATE_r or RPE_t is more than 1.5 x the JAX number, or its
ATE_r ends above the init's (the noised poses, or identity for joint).

Run:  python3 -m nope_nerf_torch.tools.demo_protocol [--protocols drive vk joint]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX package's numbers on a TPU (README.md:45-68, BASELINE.md:62,66)
JAX_NUMBERS = {
    "joint": {"ate_r_deg": 0.65, "ate_r_init_deg": 4.5, "steps": 31000},
    "drive": {"psnr": 24.24, "ssim": 0.955, "abs_rel": 0.029, "a1": 0.999,
              "ate_r_deg": 0.48, "ate_r_init_deg": 1.34, "rpe_t_cm": 2.4,
              "rpe_r_deg": 0.083, "epochs": 3000},
    "vk": {"psnr": 23.29, "ssim": 0.922, "abs_rel": 0.0285, "a1": 0.994,
           "ate_r_deg": 0.34, "ate_r_init_deg": 1.34, "rpe_t_cm": 2.1,
           "rpe_r_deg": 0.097, "epochs": 1000},
}

_FLOAT = r"([-+]?[0-9.]+(?:e[-+]?[0-9]+)?)"


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


class Runner:
    def __init__(self, work: str, logs: str):
        self.work, self.logs = work, logs
        os.makedirs(work, exist_ok=True)
        os.makedirs(logs, exist_ok=True)
        self.summary: Dict[str, Dict] = {"card": card_line()}
        self.walls: Dict[str, float] = {}

    def run(self, name: str, args: List[str]) -> str:
        """`python3 -m <args>` in the work directory; its output, also
        written to <logs>/<name>.log line by line."""
        cmd = [sys.executable, "-m"] + args
        print(f"$ {' '.join(args)}", flush=True)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.time()
        lines = []
        with open(os.path.join(self.logs, f"{name}.log"), "w") as log:
            proc = subprocess.Popen(cmd, cwd=self.work, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            for line in proc.stdout:
                log.write(line)
                log.flush()
                lines.append(line)
            rc = proc.wait()
        wall = time.time() - t0
        print(f"  {name}: exit {rc}, {wall:.1f} s wall; last lines:", flush=True)
        for line in lines[-4:]:
            print("    " + line.rstrip(), flush=True)
        if rc != 0:
            raise RuntimeError(f"{' '.join(args)} exited {rc}; see {name}.log")
        self.walls[name] = wall
        return "".join(lines)

    def save(self) -> None:
        with open(os.path.join(self.logs, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=1)


def init_ate(work: str, config: str) -> Dict[str, float]:
    """ATE/RPE of the scene's COLMAP-stand-in poses against GT (what cli.eval_poses
    reports for a checkpoint whose learned pose corrections are zero)."""
    from ..config import load_config
    from ..data import DataField
    from ..evaluation.pose_eval import full_pose_evaluation
    cwd = os.getcwd()
    os.chdir(work)
    try:
        scene = DataField.from_cfg(load_config(config), mode="train").scene
    finally:
        os.chdir(cwd)
    m = full_pose_evaluation(scene.c2ws_init, scene.c2ws_gt, reverse_est=scene.reverse,
                             reverse_gt=scene.reverse)
    return {"ate_r_deg": m["ate_r_v2_deg"], "ate_t_m": m["ate_trans"],
            "rpe_t_cm": m["rpe_trans"] * 100, "rpe_r_deg": m["rpe_rot_deg"]}


def parse_train(text: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    ate = re.findall(rf"(\d+) ep: ATE_t {_FLOAT} ATE_r {_FLOAT}deg RPE_r {_FLOAT}deg", text)
    if ate:
        ep, t, r, rr = ate[-1]
        out.update(epoch=int(ep), train_ate_t_m=float(t), train_ate_r_deg=float(r))
    psnr = re.findall(rf"(\d+) ep: Train PSNR {_FLOAT}", text)
    if psnr:
        out["train_psnr"] = float(psnr[-1][1])
    return out


def parse_eval_poses(text: str) -> Dict[str, float]:
    m = re.search(rf"ATE_t: {_FLOAT} m, ATE_t_v2: {_FLOAT} m, ATE_r_v2: {_FLOAT} deg, "
                  rf"RPE_t: {_FLOAT} cm, RPE_r: {_FLOAT} deg", text)
    if not m:
        return {}
    t, _, r, rt, rr = map(float, m.groups())
    return {"ate_t_m": t, "ate_r_deg": r, "rpe_t_cm": rt, "rpe_r_deg": rr}


def parse_eval(text: str) -> Dict[str, float]:
    """cli.eval's summary dict, as printed (numpy scalars in their repr)."""
    for line in reversed(text.splitlines()):
        if line.startswith("{'mean_mse'"):
            out = {}
            for key in ("mean_psnr", "mean_ssim", "abs_rel", "rmse", "a1"):
                m = re.search(rf"'{key}': (?:np\.float\d+\()?{_FLOAT}", line)
                if m:
                    out[key.replace("mean_", "")] = float(m.group(1))
            return out
    return {}


def verdict(protocol: str, res: Dict) -> Dict:
    """The fixed rule against the JAX numbers; `miss` lists what missed."""
    jax = JAX_NUMBERS.get(protocol)
    miss = []
    poses, ev, init = res.get("eval_poses", {}), res.get("eval", {}), res.get("init", {})
    if jax and "psnr" in ev and ev["psnr"] < jax["psnr"] - 1.0:
        miss.append(f"PSNR {ev['psnr']:.2f} < {jax['psnr']} - 1.0")
    if jax and "ate_r_deg" in poses and poses["ate_r_deg"] > 1.5 * jax["ate_r_deg"]:
        miss.append(f"ATE_r {poses['ate_r_deg']:.4f} > 1.5 x {jax['ate_r_deg']}")
    if jax and "rpe_t_cm" in poses and poses["rpe_t_cm"] > 1.5 * jax["rpe_t_cm"]:
        miss.append(f"RPE_t {poses['rpe_t_cm']:.4f} > 1.5 x {jax['rpe_t_cm']}")
    if "ate_r_deg" in poses and "ate_r_deg" in init and poses["ate_r_deg"] > init["ate_r_deg"]:
        miss.append(f"ATE_r {poses['ate_r_deg']:.4f} above the init's {init['ate_r_deg']:.4f}")
    return {"jax_tpu": jax, "miss": miss, "held": not miss}


def scene_protocol(r: Runner, name: str, config: str, scene_args: List[str],
                   epochs: List[int]) -> None:
    res: Dict = {"config": config, "walls_s": {}}
    r.summary[name] = res
    r.walls = res["walls_s"]
    r.run(f"{name}_make_demo_scene", ["nope_nerf_torch.scripts.make_demo_scene"] + scene_args)
    res["init"] = init_ate(r.work, config)
    print(f"  noised init: {res['init']}", flush=True)
    for e in epochs:
        res["train"] = parse_train(r.run(f"{name}_train_{e}", [
            "nope_nerf_torch.cli.train", config, "--max-epochs", str(e)]))
        r.save()
    res["eval_poses"] = parse_eval_poses(r.run(f"{name}_eval_poses", [
        "nope_nerf_torch.cli.eval_poses", config, "--vis"]))
    r.save()
    res["eval"] = parse_eval(r.run(f"{name}_eval", ["nope_nerf_torch.cli.eval", config]))
    r.save()
    r.run(f"{name}_render", ["nope_nerf_torch.cli.render", config])
    res["verdict"] = verdict(name, res)
    r.save()


JOINT_EPOCHS = 31000 // 8


def joint_protocol(r: Runner, epochs: int = JOINT_EPOCHS) -> None:
    res: Dict = {"walls_s": {}}
    r.summary["joint"] = res
    r.walls = res["walls_s"]
    text = r.run("joint", ["nope_nerf_torch.scripts.demo_joint_pose_training",
                           "--epochs", str(epochs)])
    first = re.search(rf"initial: ATE_t {_FLOAT} m, ATE_r {_FLOAT} deg", text)
    last = re.search(rf"final: ATE_t {_FLOAT} m .*ATE_r {_FLOAT} deg", text)
    rows = re.findall(rf"ep +(\d+): PSNR +{_FLOAT} +ATE_t {_FLOAT} +ATE_r {_FLOAT}deg", text)
    res.update(epochs=epochs, steps=8 * epochs,
               init={"ate_t_m": float(first[1]), "ate_r_deg": float(first[2])},
               final={"ate_t_m": float(last[1]), "ate_r_deg": float(last[2]),
                      "train_psnr": float(rows[-1][1]) if rows else None},
               ate_r_deg_by_epoch={int(ep): float(a) for ep, _, _, a in rows})
    jax = JAX_NUMBERS["joint"]
    final, init, miss = res["final"]["ate_r_deg"], res["init"]["ate_r_deg"], []
    if final > 1.5 * jax["ate_r_deg"]:
        miss.append(f"ATE_r {final:.4f} > 1.5 x {jax['ate_r_deg']}")
    if final > init:
        miss.append(f"ATE_r {final:.4f} above the init's {init:.4f}")
    res["verdict"] = {"jax_tpu": jax, "miss": miss, "held": not miss}
    r.save()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocols", nargs="+", default=["drive", "vk", "joint"],
                    choices=("drive", "vk", "joint"))
    ap.add_argument("--work", default=os.path.join(REPO, "build", "demo_protocol"))
    ap.add_argument("--logs", default=os.path.join(REPO, "chiprun_out", "demo_protocol"))
    ap.add_argument("--drive-epochs", type=int, nargs="+", default=[1000, 2000, 3000])
    args = ap.parse_args(argv)

    r = Runner(os.path.abspath(args.work), os.path.abspath(args.logs))
    print(r.summary["card"], flush=True)
    t0 = time.time()
    try:
        for p in args.protocols:
            if p == "drive":
                scene_protocol(r, "drive", os.path.join(REPO, "configs", "demo_drive.yaml"), [],
                               args.drive_epochs)
            elif p == "vk":
                scene_protocol(r, "vk", os.path.join(REPO, "configs", "demo_drive_vk.yaml"),
                               ["--dest", "data/demo_vk/drive", "--height", "188",
                                "--width", "621"], [1000])
            else:
                joint_protocol(r)
    finally:
        r.summary["wall_s"] = time.time() - t0
        r.save()
        print(json.dumps(r.summary))


if __name__ == "__main__":
    main()
