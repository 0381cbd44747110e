"""The port's scene-preparation CLIs against the JAX package's on the CPU:
cli/preprocess.py (DPT depth priors of a scene on disk) and cli/get_vkitti.py
(an LLFF scene and its yamls from a raw V-KITTI tree).

preprocess runs the small DPT configuration of tests/test_dpt.py, patched in
for both packages as tests/test_dpt.py patches it, over a V-KITTI-layout
scene that each package reads through its own DataField from its own copy
(the image caches are keyed by directory name). The priors agree within 1e-4
of their largest magnitude; the preview PNGs (uint8 truncations of them)
within one step. get_vkitti's pose files are bit-equal, the copied PNGs and
disparity previews pixel-equal, and its yamls load to the same dicts, also
when the port writes them without PyYAML.
"""

import copy
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import nope_nerf_tpu.cli.get_vkitti as jgv
import nope_nerf_tpu.cli.preprocess as jpp
import nope_nerf_tpu.models.dpt as jdpt
from nope_nerf_tpu.config import load_config as jax_load_config

import nope_nerf_torch.cli.get_vkitti as tgv
import nope_nerf_torch.cli.preprocess as tpp
import nope_nerf_torch.models.dpt as tdpt
from nope_nerf_torch.config import load_config
from nope_nerf_torch.data import DataField, make_driving_scene, write_vkitti_scene
from nope_nerf_torch.data.image_io import read_png, write_png

torch.set_num_threads(2)

SMALL = dict(features=32, vit_dim=64, vit_heads=4, vit_blocks=2, resnet_layers=(1, 1, 1),
             hooks=(0, 1), patch_grid=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "configs", "V_KITTI", "preprocess_straight.yaml")) as _f:
    PREPROCESS_STRAIGHT = yaml.safe_load(_f)


@pytest.mark.parametrize("name", ["preprocess_straight", "straight_d2"])
def test_chip_smoke_configs_equal_the_yaml_files(name):
    """chip_smoke.py's phase 8 reads these two yamls through the port's
    load_config (the card's machine has no PyYAML) and puts its cuts on top
    (chip_smoke.disk_cuts): the file's dict plus the listed cuts, nothing else."""
    rel = f"configs/V_KITTI/{name}.yaml"
    from_yaml = jax_load_config(os.path.join(REPO, rel))
    assert chip_smoke.CONFIG_FILES[name] == rel
    assert chip_smoke.shipped_config(name) == load_config(os.path.join(REPO, rel)) == from_yaml
    root = "/disk/root"
    cuts = chip_smoke.disk_cuts(name, root)
    cfg = chip_smoke.disk_config(name, root)
    assert cfg == jax_load_config(os.path.join(REPO, rel), overrides=cuts)
    changed = {(sec, k) for sec, d in cfg.items() for k, v in d.items() if v != from_yaml[sec][k]}
    assert changed <= {(sec, k) for sec, d in cuts.items() for k in d}
    assert cfg["dataloading"]["path"] == os.path.join(root, "V_KITTI")


def test_preprocess_matches_jax(tmp_path, monkeypatch):
    for mod, cls in ((jdpt, jdpt.DPTConfig), (tdpt, tdpt.DPTConfig)):
        monkeypatch.setattr(cls, "from_cfg",
                            classmethod(lambda c, cfg, mod=mod: mod.DPTConfig(**SMALL)))
    scene = make_driving_scene(n_frames=3, h=64, w=96, seed=2)
    write_vkitti_scene(str(tmp_path / "src" / "straight"), scene, pose_noise_deg=1.0, seed=3)
    out = {}
    for pkg, fn, loader in (("jax", jpp.preprocess, jax_load_config),
                            ("torch", tpp.preprocess, load_config)):
        shutil.copytree(tmp_path / "src", tmp_path / pkg)
        over = copy.deepcopy(PREPROCESS_STRAIGHT)
        over["dataloading"]["path"] = str(tmp_path / pkg)
        kwargs = {"device": "cpu"} if pkg == "torch" else {}
        out[pkg] = fn(loader(overrides=over), random_weights=True, **kwargs)
    assert out["torch"] == str(tmp_path / "torch" / "straight" / "dpt")
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["torch"]))
    assert [n for n in names if n.endswith(".npz")] == [f"depth_{i:05d}.npz" for i in range(3)]
    for name in names:
        a, b = (os.path.join(out[p], name) for p in ("jax", "torch"))
        if name.endswith(".npz"):
            want, got = np.load(a)["pred"], np.load(b)["pred"]
            # 32x48 frames (64x96 halved) go into the net at 384x576
            assert got.dtype == np.float32 and got.shape == want.shape == (384, 576)
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        else:
            want, got = cv2.imread(a, cv2.IMREAD_UNCHANGED), read_png(b)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.abs(got.astype(int) - want).max() <= 1


def test_preprocess_needs_a_device_or_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpp.preprocess(load_config(overrides=PREPROCESS_STRAIGHT), random_weights=True)


# ---- get_vkitti ----------------------------------------------------------------------

N_RAW, RAW_H, RAW_W = 9, 30, 100


def write_raw_vkitti(root, version="1.3.1", drive="0001", variation="clone"):
    """A raw V-KITTI tree: RGB and 16-bit depth (cm) PNGs and the extrinsics txt
    of a car that drives forward, turning and speeding up unevenly."""
    rng = np.random.default_rng(0)
    rgb_dir = os.path.join(root, f"vkitti_{version}_rgb", drive, variation)
    depth_dir = os.path.join(root, f"vkitti_{version}_depthgt", drive, variation)
    extr_dir = os.path.join(root, f"vkitti_{version}_extrinsicsgt")
    for d in (rgb_dir, depth_dir, extr_dir):
        os.makedirs(d)
    lines = ["frame r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 r3,1 r3,2 r3,3 t3 0 0 0 1"]
    yaw, z = 0.0, 0.0
    for i in range(N_RAW):
        write_png(os.path.join(rgb_dir, f"{i:05d}.png"),
                  rng.integers(0, 256, (RAW_H, RAW_W, 3), dtype=np.uint8))
        depth = rng.integers(200, 8000, (RAW_H, RAW_W)).astype(np.uint16)
        depth[0, :5] = 0                                  # pixels without depth
        write_png(os.path.join(depth_dir, f"{i:05d}.png"), depth)
        yaw += 0.02 * (i % 3)
        z += 0.4 + 0.3 * (i % 2)
        c, s = np.cos(yaw), np.sin(yaw)
        c2w = np.array([[c, 0, s, 0.1 * i], [0, 1, 0, -1.5], [-s, 0, c, z], [0, 0, 0, 1]])
        w2c = np.linalg.inv(c2w)
        lines.append(f"{i} " + " ".join(f"{v:.9f}" for v in w2c.reshape(-1)))
    with open(os.path.join(extr_dir, f"{drive}_{variation}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


CASES = {
    "interval": ["interval", "-i", "2", "--customised-poses", "--mock-colmap-poses",
                 "--with-depth"],
    "threshold": ["threshold", "-r", "0.03", "-t", "0.6", "-i", "1", "--resize-factor", "2",
                  "--simulate-vanilla", "--sparsify-depth", "--depth-scale", "1e-5",
                  "--customised-poses"],
}


@pytest.mark.parametrize("without_yaml", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_get_vkitti_matches_jax(tmp_path, monkeypatch, case, without_yaml):
    write_raw_vkitti(str(tmp_path / "raw"))
    argv = [str(tmp_path / "raw"), "1.3.1", "0001", "drive"] + CASES[case]
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["get_vkitti"] + argv)
            jgv.main()
        else:
            with monkeypatch.context() as m:
                if without_yaml:
                    m.setitem(sys.modules, "yaml", None)
                tgv.main(argv)
    scene = {p: tmp_path / p / "data" / "V_KITTI" / "drive" for p in ("jax", "torch")}
    files = sorted(os.listdir(scene["jax"]))
    assert files == sorted(os.listdir(scene["torch"]))
    assert "gt_poses.npz" in files and "disp" in files
    for name in ("poses_gt.npy", "poses_bounds.npy"):
        if name in files:
            np.testing.assert_array_equal(np.load(scene["torch"] / name),
                                          np.load(scene["jax"] / name))
    for name, key in (("gt_poses.npz", "poses"), ("intrinsics.npz", "K")):
        np.testing.assert_array_equal(np.load(scene["torch"] / name)[key],
                                      np.load(scene["jax"] / name)[key])
    for sub in ("images", "depth", "disp"):
        names = sorted(os.listdir(scene["jax"] / sub))
        assert names == sorted(os.listdir(scene["torch"] / sub)) and names
        for n in names:
            np.testing.assert_array_equal(read_png(str(scene["torch"] / sub / n)),
                                          read_png(str(scene["jax"] / sub / n)))
    rows = np.load(scene["torch"] / "poses_gt.npy")
    assert rows.shape[1] == 17 and (case != "threshold" or 1 < len(rows) < N_RAW)

    for name in ("drive.yaml", "preprocess_drive.yaml"):
        j, t = (str(tmp_path / p / "configs" / "V_KITTI" / name) for p in ("jax", "torch"))
        with open(j) as f, open(t) as g:
            raw_j, raw_t = yaml.safe_load(f), yaml.safe_load(g)
        assert raw_t == raw_j
        want = load_config(j)
        with open(t) as f:
            text = f.read()
        # block YAML from the port's emitter, whether PyYAML was there or not
        assert not text.lstrip().startswith("{") and tgv.yaml_subset.loads(text) == raw_j
        with monkeypatch.context() as m:
            if without_yaml:
                m.setitem(sys.modules, "yaml", None)
            assert load_config(t) == want
        assert jax_load_config(j)["dataloading"] == jax_load_config(t)["dataloading"]

    # the port's scene loads through its DataField, from the yaml it wrote (a scene
    # without depth supervision and without priors yet: the online-DPT mode)
    over = {"dataloading": {"path": str(scene["torch"].parent)}}
    if "--with-depth" not in argv:
        over["depth"] = {"type": "DPT"}
    cfg = load_config(str(tmp_path / "torch" / "configs" / "V_KITTI" / "drive.yaml"),
                      overrides=over)
    field = DataField.from_cfg(cfg, mode="all")
    rf = cfg["dataloading"]["resize_factor"]
    assert field.scene.imgs.shape == (len(rows), RAW_H // rf, RAW_W // rf, 3)


def test_flow_emitter_reads_back_in_json_and_yaml():
    """get_vkitti's yamls go through yaml_subset.dumps: block YAML that the port's
    reader and yaml.safe_load read back; the JSON-form yamls the port wrote
    before read back too."""
    data = {"a": {"path": "out/V_KITTI/x y", "scene": ["straight"], "n": 3, "neg": -2,
                  "f": 0.01, "tiny": 1e-5, "big": 1e20, "third": 1 / 3, "flag": True,
                  "off": False, "none": None, "pattern": [1, 0, 1, 0], "empty": {}},
            "quote": 'say "hi"\\', "unicode": "dépth"}
    text = tgv.yaml_subset.dumps(data)
    assert tgv.yaml_subset.loads(text) == data
    assert yaml.safe_load(text) == data
    as_json = json.dumps(data).replace("1e-05", "1.0e-05").replace("1e+20", "1.0e+20")
    assert json.loads(as_json) == data
    assert tgv.yaml_subset.loads(as_json) == yaml.safe_load(as_json) == data
    nan = tgv.yaml_subset.loads(tgv.yaml_subset.dumps({"x": float("nan")}))["x"]
    assert nan != nan
