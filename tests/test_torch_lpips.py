"""The port's LPIPS (nope_nerf_torch/evaluation/lpips.py) against the JAX
package's on the CPU, and its wiring into eval_image and the eval CLI.

Seeded random weights at the full VGG16 width: the math does not depend on
the pretrained values. Both packages convolve in float32 in another order,
so distances agree within rtol 1e-5; identical images give exactly 0.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax.numpy as jnp

from nope_nerf_tpu.evaluation.lpips import load_lpips_params as jax_load
from nope_nerf_tpu.evaluation.lpips import lpips_pair as jax_lpips_pair

import nope_nerf_torch.evaluation.image_eval as image_eval
from nope_nerf_torch.cli.eval import evaluate
from nope_nerf_torch.cli.train import train
from nope_nerf_torch.config import load_config
from nope_nerf_torch.convert import lpips_params_from_jax
from nope_nerf_torch.evaluation.lpips import (TAP_CHANNELS, VGG16_CHANNELS, VGG16_CONV_IDX,
                                              convert_torch_lpips,
                                              get_lpips_fn, load_lpips_params, lpips_flops,
                                              lpips_pair, set_lpips_weights)

torch.set_num_threads(2)

RTOL = 1e-5


def random_params(seed: int):
    """VGG16 convs at full width (OIHW, scaled to keep activations of order 1)
    and non-negative lin heads, as numpy."""
    rng = np.random.default_rng(seed)
    params, c_in = {}, 3
    for idx, c_out in zip(VGG16_CONV_IDX, VGG16_CHANNELS):
        params[f"features.{idx}.weight"] = (
            rng.standard_normal((c_out, c_in, 3, 3)) / np.sqrt(9 * c_in)).astype(np.float32)
        params[f"features.{idx}.bias"] = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
        c_in = c_out
    for k, c in enumerate(TAP_CHANNELS):
        params[f"lin{k}.weight"] = np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32)
    return params


def _pair(seed, h, w):
    rng = np.random.default_rng(seed + 100)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


def _jax(params, a, b) -> float:
    return float(jax_lpips_pair({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(a), jnp.asarray(b)))


def _torch(params, a, b) -> float:
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    return float(lpips_pair(tp, torch.from_numpy(a), torch.from_numpy(b)))


@pytest.fixture(autouse=True)
def _no_weights_after():
    """The metric's weight path is module state: leave it unset for the next test."""
    yield
    set_lpips_weights(None)


@pytest.mark.parametrize("h,w,seed", [(32, 48, 0), (37, 53, 1)])
def test_lpips_matches_jax(h, w, seed):
    params = random_params(seed)
    a, b = _pair(seed, h, w)
    want, got = _jax(params, a, b), _torch(params, a, b)
    assert want > 0
    assert got == pytest.approx(want, rel=RTOL), (got, want)


def test_flop_count_is_the_convs():
    params = {k: torch.from_numpy(v) for k, v in random_params(0).items()}
    a, b = (torch.from_numpy(x) for x in _pair(0, 37, 53))
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        lpips_pair(params, a, b)
    assert counter.get_total_flops() == lpips_flops(37, 53)


def test_identical_images_give_exactly_zero():
    params = random_params(2)
    a, _ = _pair(2, 32, 48)
    assert _torch(params, a, a.copy()) == 0.0


@pytest.mark.parametrize("form", ["npz", "pt", "pt_lpips_layout"])
def test_weight_files_load(tmp_path, form):
    params = random_params(3)
    if form == "npz":
        path = tmp_path / "lpips.npz"
        np.savez(path, **params)
    else:
        sd = {k: torch.from_numpy(v) for k, v in params.items()}
        if form == "pt_lpips_layout":     # the lpips package names its heads lin<k>.model.1
            sd = {k.replace(".weight", ".model.1.weight") if k.startswith("lin") else k: v
                  for k, v in sd.items()}
        path = tmp_path / "lpips.pt"
        torch.save(sd, path)
    loaded = load_lpips_params(str(path), device="cpu")
    assert set(loaded) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v)
    a, b = _pair(3, 16, 24)
    got = float(lpips_pair(loaded, torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(_jax(params, a, b), rel=RTOL)


def test_convert_torch_lpips_merges_what_both_packages_load(tmp_path):
    params = random_params(4)
    torch.save({k: torch.from_numpy(v) for k, v in params.items() if k.startswith("features.")},
               tmp_path / "vgg16.pth")
    torch.save({f"lin{k}.model.1.weight": torch.from_numpy(params[f"lin{k}.weight"])
                for k in range(5)}, tmp_path / "lpips_vgg.pth")
    convert_torch_lpips(str(tmp_path / "vgg16.pth"), str(tmp_path / "lpips_vgg.pth"),
                        str(tmp_path / "merged.npz"))
    ours = load_lpips_params(str(tmp_path / "merged.npz"), device="cpu")
    theirs = lpips_params_from_jax({k: np.asarray(v) for k, v in
                                    jax_load(str(tmp_path / "merged.npz")).items()}, "cpu")
    assert set(ours) == set(theirs) == set(params)
    for k in params:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("broken,error", [
    ("features.28.bias", KeyError), ("lin3.weight", KeyError), ("lin2 size", ValueError)])
def test_incomplete_weights_raise(tmp_path, broken, error):
    params = random_params(5)
    if broken == "lin2 size":
        params["lin2.weight"] = params["lin2.weight"][:, :100]
    else:
        del params[broken]
    np.savez(tmp_path / "broken.npz", **params)
    with pytest.raises(error, match="lin2.weight must have 256" if error is ValueError
                       else f"missing {broken}"):
        load_lpips_params(str(tmp_path / "broken.npz"), device="cpu")
    with pytest.raises(error):
        lpips_params_from_jax(params, "cpu")


def test_eval_image_fills_lpips(tmp_path):
    params = random_params(6)
    np.savez(tmp_path / "lpips.npz", **params)
    a, b = _pair(6, 24, 32)
    assert image_eval.eval_image(a, b)["lpips"] is None           # no weights configured
    set_lpips_weights(str(tmp_path / "lpips.npz"), "cpu")
    r = image_eval.eval_image(a, b)
    assert r["lpips"] == pytest.approx(_jax(params, a, b), rel=RTOL)
    assert image_eval.eval_image(a, b, with_lpips=False)["lpips"] is None
    set_lpips_weights(str(tmp_path / "missing.npz"), "cpu")
    assert get_lpips_fn() is None


def test_eval_cli_reports_lpips_as_jax_computes_it(tmp_path, monkeypatch):
    """cli.eval with a weight file: each view's LPIPS is JAX's lpips_pair on the
    frames the CLI rendered, mean_lpips their mean, and evaluation.txt prints it."""
    params = random_params(7)
    np.savez(tmp_path / "lpips.npz", **params)
    cfg = load_config(overrides={
        "model": {"hidden_dim": 32}, "rendering": {"num_points": 8},
        "training": {"n_training_points": 64, "out_dir": str(tmp_path / "out"),
                     "print_every": 0, "checkpoint_every": 0, "backup_every": 0,
                     "visualize_every": 0, "vis_reprojection_every": 0, "vis_geo": False},
        "pose": {"learn_pose": True, "init_pose": True},
        "eval_pose": {"opt_pose_epoch": 1, "n_points": 64},
        "extract_images": {"lpips_weights": str(tmp_path / "lpips.npz")}})
    train(cfg, synthetic=True, max_epochs=1, device="cpu")
    seen = []
    real = image_eval.eval_image

    def recording(rgb_pred, rgb_gt, *args, **kwargs):
        r = real(rgb_pred, rgb_gt, *args, **kwargs)
        seen.append((np.array(rgb_pred, np.float32), np.array(rgb_gt, np.float32), r["lpips"]))
        return r

    monkeypatch.setattr(image_eval, "eval_image", recording)
    summary = evaluate(cfg, synthetic=True, device="cpu", save=False)
    assert seen
    for rgb_pred, rgb_gt, got in seen:
        assert got == pytest.approx(_jax(params, rgb_pred, rgb_gt), rel=RTOL)
    assert summary["mean_lpips"] == pytest.approx(np.mean([s[2] for s in seen]), rel=1e-12)
    text = open(os.path.join(cfg["training"]["out_dir"], "extraction", "evaluation.txt")).read()
    assert "LPIPS {0:.2f}".format(summary["mean_lpips"]) in text and "LPIPS n/a" not in text
