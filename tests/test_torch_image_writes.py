"""The port's image writes go through its own PNG writer (data/image_io.py), so
the train CLI's visualize, vis_geo and reprojection hooks, evaluate(save=True)
and render(save=True) run where imageio, cv2 and matplotlib are missing, as on
the card's machine.

Each test blocks those packages in sys.modules (as test_torch_isolation.py
does in its subprocess), runs the entry point on the built-in synthetic scene
at a tiny width, records every array the port hands its writer, and reads each
PNG back with read_png: pixel-equal to that array, and to the same array as
the JAX package's writer writes it (imageio, once the block is lifted). The
evaluation artifacts are held against the JAX package's write_view_artifacts
on the same inputs, file by file. What needs a blocked package (INFERNO
disparity maps, the depth-error scatter, videos) is skipped with a message.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

import imageio.v2 as imageio

from nope_nerf_tpu.evaluation import artifacts as jax_artifacts

from nope_nerf_torch.cli import train as cli_train
from nope_nerf_torch.cli.eval import evaluate
from nope_nerf_torch.cli.render import render
from nope_nerf_torch.config import load_config
from nope_nerf_torch.data.image_io import read_png, write_png
from nope_nerf_torch.evaluation import artifacts, extract

torch.set_num_threads(2)

BLOCKED = ("imageio", "imageio.v2", "cv2", "matplotlib")


def _cfg(out_dir, **training):
    over = {
        "model": {"hidden_dim": 32},
        "rendering": {"num_points": 8},
        "training": {"n_training_points": 64, "out_dir": str(out_dir), "print_every": 0,
                     "checkpoint_every": 0, "backup_every": 0, "visualize_every": 0,
                     "vis_reprojection_every": 0, "eval_pose_every": 1, "eval_img_every": 1,
                     "vis_geo": False, **training},
        "pose": {"learn_pose": True, "init_pose": True},
        "extract_images": {"N_novel_imgs": 3, "resolution": [12, 16]},
        "eval_pose": {"opt_pose_epoch": 1, "n_points": 64},
    }
    return load_config(overrides=over)


class _Log(list):
    """The (path, array) pairs written, and the blocked packages' modules."""
    saved: dict


@pytest.fixture
def written(monkeypatch):
    """Blocks the optional packages and records (path, array) of every PNG
    the port writes."""
    saved = {name: sys.modules.get(name) for name in BLOCKED}
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    log = _Log()
    log.saved = saved

    def recording(path, img, *args, **kwargs):
        log.append((path, np.array(img)))
        write_png(path, img, *args, **kwargs)

    for module in (cli_train, extract, artifacts):
        monkeypatch.setattr(module, "write_png", recording)
    return log


def _unblock(log, monkeypatch):
    """Lift the block: the packages as they were before the test."""
    for name, module in log.saved.items():
        if module is None:
            monkeypatch.delitem(sys.modules, name, raising=False)
        else:
            monkeypatch.setitem(sys.modules, name, module)


def _check_round_trip(log, tmp_path):
    """Every recorded PNG reads back as its array, and as imageio writes it."""
    assert log
    for i, (path, arr) in enumerate(log):
        got = read_png(path)
        np.testing.assert_array_equal(got, arr)
        ref_path = str(tmp_path / f"imageio_{i}.png")
        imageio.imwrite(ref_path, arr)
        np.testing.assert_array_equal(read_png(ref_path), got)


def test_train_hooks_write_pngs_without_imageio_or_cv2(tmp_path, written, monkeypatch):
    cfg = _cfg(tmp_path / "out", visualize_every=1, vis_geo=True, vis_resolution=[6, 8],
               vis_reprojection_every=1)
    cli_train.train(cfg, synthetic=True, max_epochs=1, device="cpu")
    _unblock(written, monkeypatch)
    rendering = tmp_path / "out" / "rendering"
    vis_dirs = sorted(glob.glob(str(rendering / "*_vis")))
    assert len(vis_dirs) == 8                     # one per step of the 8-frame epoch
    for d in vis_dirs:
        assert sorted(os.listdir(d)) == ["depth.png", "geo.png", "rgb.png"]
    assert len(glob.glob(str(rendering / "*_img1.png"))) == 8
    assert len(glob.glob(str(rendering / "*_img2.png"))) == 8
    assert len(written) == 8 * 3 + 8 * 2
    _check_round_trip(written, tmp_path)


def test_evaluate_save_writes_pngs_without_imageio_or_cv2(tmp_path, written, monkeypatch, capsys):
    cfg = _cfg(tmp_path / "out")
    cli_train.train(cfg, synthetic=True, max_epochs=1, device="cpu")
    calls = []
    port_writer = artifacts.write_view_artifacts

    def recording_views(*args, **kwargs):
        calls.append((args, kwargs))
        return port_writer(*args, **kwargs)

    monkeypatch.setattr(artifacts, "write_view_artifacts", recording_views)
    summary = evaluate(cfg, synthetic=True, device="cpu", save=True)
    out = capsys.readouterr().out
    _unblock(written, monkeypatch)
    assert np.isfinite(summary["mean_psnr"]) and calls
    assert "no imageio: no eval video" in out
    extraction = tmp_path / "out" / "extraction"
    assert not (extraction / "video_out").exists() or not os.listdir(extraction / "video_out")
    assert not (extraction / "disp_out").exists()
    _check_round_trip(written, tmp_path)
    # the JAX package's artifact writer on the same inputs, PNG by PNG
    jax_dir = tmp_path / "jax"
    for args, kwargs in calls:
        jax_artifacts.write_view_artifacts(str(jax_dir), *args[1:], **kwargs)
    port_pngs = {os.path.relpath(p, extraction): p for p, _ in written}
    assert "img_out/0000.png" in port_pngs and "img_gt_out/0000.png" in port_pngs
    for rel, path in port_pngs.items():
        np.testing.assert_array_equal(read_png(path), read_png(str(jax_dir / rel)))


def test_render_save_writes_pngs_without_imageio_or_cv2(tmp_path, written, monkeypatch, capsys):
    cfg = _cfg(tmp_path / "out")
    cli_train.train(cfg, synthetic=True, max_epochs=1, device="cpu")
    written.clear()
    render(cfg, synthetic=True, device="cpu", save=True)
    out = capsys.readouterr().out
    _unblock(written, monkeypatch)
    assert "no imageio: no videos" in out
    n_views = cfg["extract_images"]["N_novel_imgs"]
    assert len(written) == 3 * n_views
    for sub in ("img", "depth", "disp"):
        assert sum(f"{os.sep}{sub}{os.sep}" in p for p, _ in written) == n_views
    assert not glob.glob(str(tmp_path / "out" / "**" / "*.mp4"), recursive=True)
    assert not glob.glob(str(tmp_path / "out" / "**" / "*.gif"), recursive=True)
    _check_round_trip(written, tmp_path)
