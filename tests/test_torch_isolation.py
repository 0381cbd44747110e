"""The port stands alone: no module of nope_nerf_torch, and not chip_smoke.py,
imports JAX or nope_nerf_tpu, and the entry points do not fall back to the CPU.

The import check runs in a subprocess whose sys.modules blocks jax,
nope_nerf_tpu and the packages the card's machine lacks (PyYAML, cv2,
imageio), so any import of them at module level fails there.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nope_nerf_torch"
BLOCKED = ("jax", "jaxlib", "nope_nerf_tpu", "optax", "chex", "yaml", "cv2", "imageio",
           "matplotlib", "PIL")
# the modules of the third to fifth slices, those of scene preparation and LPIPS, the
# multi-device layer, and the JPEG reader and its test-side writer: each must be among
# those the scan imports
REQUIRED = tuple("nope_nerf_torch." + m for m in (
    "cli.train", "cli.eval", "cli.eval_poses", "evaluation.align", "evaluation.artifacts",
    "evaluation.image_eval", "evaluation.pose_eval", "evaluation.pose_opt",
    "tools.backward_noise", "training.checkpoints", "utils.metrics", "utils.profiling",
    "ops.fused_mlp", "ops.occupancy", "ops.phong", "cli.vis_poses", "data.image_io",
    "data.llff", "data.degrade", "data.fields", "evaluation.lpips", "models.dpt",
    "data.dpt_transforms", "cli.preprocess", "cli.get_vkitti", "parallel.mesh",
    "parallel.multihost", "parallel.sharding", "data.jpeg", "tools.jpeg_writer",
    "tools.decode_timing", "yaml_subset", "scripts.make_demo_scene",
    "scripts.make_nonmetric_priors", "scripts.demo_joint_pose_training",
    "tools.demo_protocol"))

torch.set_num_threads(2)

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None
import nope_nerf_torch
names = [m.name for m in pkgutil.walk_packages(nope_nerf_torch.__path__, "nope_nerf_torch.")]
for name in names:
    importlib.import_module(name)
for name in {required!r}:
    assert name in names, name
import chip_smoke
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {blocked!r})
print(len(names), loaded)
"""

_WITHOUT_PYYAML = r"""
import glob, importlib, importlib.abc, os, pkgutil, sys

class BlockYaml(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("blocked")

sys.meta_path.insert(0, BlockYaml())
import nope_nerf_torch
from nope_nerf_torch.config import load_config, save_config
names = [m.name for m in pkgutil.walk_packages(nope_nerf_torch.__path__, "nope_nerf_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
paths = glob.glob(os.path.join({repo!r}, "configs", "**", "*.yaml"), recursive=True)
for p in paths:
    cfg = load_config(p)
    save_config(cfg, {out!r})
    assert load_config({out!r}) == cfg, p
assert "yaml" not in sys.modules
print(len(names), len(paths))
"""

_ENTRY_WITHOUT_DEVICE = r"""
import sys
sys.modules["jax"] = None
sys.modules["nope_nerf_tpu"] = None
import torch
from nope_nerf_torch.cli.render import render
from nope_nerf_torch.config import load_config
assert not torch.cuda.is_available()
try:
    render(load_config(), synthetic="driving")
except RuntimeError as e:
    print("raised:", e)
else:
    raise SystemExit("render ran without a CUDA device")
"""

_CHIP_SMOKE_WITHOUT_DEVICE = r"""
import sys
sys.modules["jax"] = None
sys.modules["nope_nerf_tpu"] = None
import chip_smoke
code = chip_smoke.main()
assert code != 0, code
print("exit", code)
"""


def _run(code, **env):
    full_env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax_or_reference():
    res = _run(_IMPORT_ALL.format(blocked=BLOCKED, required=REQUIRED))
    assert res.returncode == 0, res.stderr
    n, loaded = res.stdout.strip().split(" ", 1)
    assert int(n) >= 48       # every module of the five slices, the CLIs' included
    assert loaded == "[]", loaded


def test_every_module_and_config_without_pyyaml(tmp_path):
    """With `import yaml` failing (a sys.meta_path finder), every module of the
    port and chip_smoke.py import, and every configs/**/*.yaml loads through
    load_config and reads back from what save_config writes; no module
    names yaml in an import statement."""
    res = _run(_WITHOUT_PYYAML.format(repo=str(REPO), out=str(tmp_path / "back.yaml")))
    assert res.returncode == 0, res.stderr
    n_modules, n_configs = map(int, res.stdout.split())
    assert n_modules >= 48 and n_configs == 69
    pattern = re.compile(r"^\s*(import|from)\s+yaml\b")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert not [f"{f.relative_to(REPO)}:{i}" for f in files
                for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]


def test_no_import_statement_names_jax_or_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|nope_nerf_tpu|optax|chex)\b")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f.relative_to(REPO)}:{i}" for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert not offenders, offenders


def test_render_entry_point_raises_without_cuda():
    res = _run(_ENTRY_WITHOUT_DEVICE, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "no CUDA device" in res.stdout


_CLI_WITHOUT_DEVICE = r"""
import sys, tempfile
sys.modules["jax"] = None
sys.modules["nope_nerf_tpu"] = None
import torch
from nope_nerf_torch.cli.eval import evaluate
from nope_nerf_torch.cli.eval_poses import evaluate_poses
from nope_nerf_torch.cli.train import train
from nope_nerf_torch.config import load_config
assert not torch.cuda.is_available()
cfg = load_config(overrides={"training": {"out_dir": tempfile.mkdtemp(), "vis_geo": False}})
for fn in (train, evaluate, evaluate_poses):
    try:
        fn(cfg, synthetic=True)
    except RuntimeError as e:
        print(fn.__name__, "raised:", e)
    else:
        raise SystemExit(fn.__name__ + " ran without a CUDA device")
"""


def test_train_and_eval_entry_points_raise_without_cuda():
    res = _run(_CLI_WITHOUT_DEVICE, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("no CUDA device") == 3, res.stdout


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    res = _run(_CHIP_SMOKE_WITHOUT_DEVICE, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "exit 1" and '"ok"' not in res.stdout


def test_train_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    from nope_nerf_torch.config import load_config
    from nope_nerf_torch.data import SceneData, make_synthetic_scene
    from nope_nerf_torch.models.distortions import DistortionConfig, init_distortion_params
    from nope_nerf_torch.models.intrinsics import FocalConfig, init_focal_params
    from nope_nerf_torch.training import ModelConfigs, create_train_state
    scene = SceneData.from_dict(make_synthetic_scene(n_frames=2, h=8, w=8))
    mc = ModelConfigs.from_cfg(load_config(overrides={"model": {"hidden_dim": 128}}), 2)
    for call in (lambda: create_train_state(0, mc),
                 lambda: scene.to_device(),
                 lambda: init_distortion_params(DistortionConfig(num_cams=2)),
                 lambda: init_focal_params(FocalConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    state = create_train_state(0, mc, device="cpu")
    assert state.generator.device.type == "cpu"
    assert all(v.device.type == "cpu" for d in state.params.values() for v in d.values())


def test_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the default device is valid")
    from nope_nerf_torch import resolve_device
    from nope_nerf_torch.evaluation.extract import render_trajectory
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.render import RenderConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_nerf_params(NerfConfig(hidden_dim=128), torch.Generator().manual_seed(0))
    params = init_nerf_params(NerfConfig(hidden_dim=128), torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_trajectory(params, np.eye(4, dtype=np.float32)[None], np.eye(4), (4, 4),
                          NerfConfig(hidden_dim=128), RenderConfig())
    assert resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    import nope_nerf_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
