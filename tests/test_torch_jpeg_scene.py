"""A scene whose frames are JPEG files, in the Tanks layout (as configs/Tanks/
*.yaml read them), through the port's DataField and through the JAX
package's on the same directory, on the CPU.

The scene is written by the port's write_vkitti_scene and its frames
re-encoded as JPEG, by cv2 (4:2:0, 4:2:2 with restarts, progressive, an Exif
orientation of 1, optimised Huffman tables) or by the port's test-side
writer. Each package reads its own copy (the caches are keyed by directory
name). At full size the images are exactly equal: the port decodes JPEG
bit-equal to cv2.imread. With resize_factor 2 the minified cache is PNG in
both, its pixels within one step of 255 (the port's INTER_AREA rounds in
float64, cv2's in fixed point; see tests/test_torch_image_io.py). Poses,
names, `reverse` and masks are bit-equal.
"""

import copy
import os
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import nope_nerf_tpu.data as J                                       # noqa: E402

import nope_nerf_torch.data as T                                     # noqa: E402
from nope_nerf_torch.config import load_config                      # noqa: E402
from nope_nerf_torch.data.image_io import read_png                  # noqa: E402
from nope_nerf_torch.tools.jpeg_writer import write_jpeg            # noqa: E402

FIELDS = ("imgs", "depths", "depth_masks", "c2ws_gt", "c2ws_init", "K", "gt_depths",
          "i_train", "i_test")
H, W, N_FRAMES = 54, 96, 6
# cv2's parameters for each frame: the Tanks scenes ship JPEG frames of varied make
CV2_MODES = [
    [cv2.IMWRITE_JPEG_QUALITY, 95],
    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    [cv2.IMWRITE_JPEG_QUALITY, 100],
]
PORT_MODES = [{"sampling": "4:4:4"}, {"sampling": "4:2:2", "restart_interval": 3},
              {"orientation": 1}, {}, {"quality": 80}, {}]
CONFIGS = {
    # configs/Tanks/*.yaml: spherify, customized_focal false, DPT npz priors, full size
    "tanks": {"dataloading": {"scene": ["Ballroom"], "customized_focal": False}},
    # the same minified by 2: the cache is written as PNG from the JPEG originals
    "tanks_d2": {"dataloading": {"scene": ["Ballroom"], "customized_focal": False,
                                 "resize_factor": 2}},
}


def _write(dest, writer, resize_factor):
    scene = T.make_driving_scene(n_frames=N_FRAMES, h=H, w=W, seed=7)
    T.write_vkitti_scene(dest, scene, pose_noise_deg=1.0, pose_noise_trans=0.05, seed=2)
    img_dir = os.path.join(dest, "images")
    for i, png in enumerate(sorted(os.listdir(img_dir))):
        rgb = read_png(os.path.join(img_dir, png))
        os.remove(os.path.join(img_dir, png))
        jpg = os.path.join(img_dir, os.path.splitext(png)[0] + (".JPG" if i == 5 else ".jpg"))
        if writer == "cv2":
            assert cv2.imwrite(jpg, np.ascontiguousarray(rgb[..., ::-1]), CV2_MODES[i])
        else:
            write_jpeg(jpg, rgb, **{"quality": 95, **PORT_MODES[i]})
    os.makedirs(os.path.join(dest, "dpt"))
    for i, depth in enumerate(scene["depths"]):
        pred = (1.0 / depth[::resize_factor, ::resize_factor]).astype(np.float32)[None]
        np.savez(os.path.join(dest, "dpt", f"depth_{i:05d}.npz"), pred=pred)


@pytest.mark.parametrize("writer", ["cv2", "port"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_jpeg_scene_matches_jax(tmp_path, kind, writer):
    over = copy.deepcopy(CONFIGS[kind])
    factor = over["dataloading"].get("resize_factor") or 1
    _write(str(tmp_path / "src" / "Ballroom"), writer, factor)
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    shutil.copytree(tmp_path / "src", tmp_path / "torch")
    for mode in ("train", "eval"):
        scenes = {}
        for pkg, mod in (("jax", J), ("torch", T)):
            o = copy.deepcopy(over)
            o["dataloading"]["path"] = str(tmp_path / pkg)
            o["dataloading"]["sample_rate"] = 3
            scenes[pkg] = mod.DataField.from_cfg(load_config(overrides=o), mode=mode).scene
        a, b = scenes["jax"], scenes["torch"]
        assert a.imgs.shape == b.imgs.shape == (a.imgs.shape[0], H // factor, W // factor, 3)
        for k in FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is None:
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if k == "imgs" and factor != 1:
                assert np.abs(x - y).max() <= 1.0 / 255 + 1e-7
                assert (x != y).mean() < 1e-3, (x != y).mean()
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{kind} {mode} {k}")
        assert a.reverse.keys() == b.reverse.keys()
        for k in a.reverse:
            np.testing.assert_array_equal(a.reverse[k], b.reverse[k])
    if factor != 1:
        # the minified cache: PNG files under the same names in both copies
        caches = [tmp_path / pkg / "Ballroom" / f"images_{factor}" for pkg in ("jax", "torch")]
        names = sorted(os.listdir(caches[0]))
        assert names == sorted(os.listdir(caches[1]))
        assert len(names) == N_FRAMES and all(n.endswith(".png") for n in names)
        for n in names:
            x, y = (cv2.imread(str(c / n)).astype(int) for c in caches)
            assert np.abs(x - y).max() <= 1


@pytest.mark.parametrize("orientation", [1, 6])
def test_crop_factors_read_the_oriented_height(tmp_path, orientation):
    """crop_factors takes the first frame's height as cv2.imread returns it:
    after the Exif orientation (6 turns a 54x96 frame to 96x54)."""
    from nope_nerf_tpu.data import llff as jllff

    from nope_nerf_torch.data import llff as tllff
    os.makedirs(tmp_path / "images")
    write_jpeg(str(tmp_path / "images" / "00000.jpg"),
               np.full((H, W, 3), 128, np.uint8), orientation=orientation)
    got = tllff.crop_factors(str(tmp_path), 4)
    assert got == jllff.crop_factors(str(tmp_path), 4)
    assert got[0] == 4 / (W if orientation == 6 else H)


def test_crop_cache_of_jpeg_originals_is_png(tmp_path):
    """With crop_size > 0 the port writes each cropped frame as PNG bytes under
    its source name (the JAX package re-encodes it as JPEG there, lossy: a
    documented difference); the port reads them back by their signature,
    exactly the pixels it cropped."""
    from nope_nerf_torch.data import llff as tllff
    from nope_nerf_torch.data.image_io import read_rgb8, resize_linear
    _write(str(tmp_path / "Ballroom"), "port", 1)
    poses, bds, imgs, names = tllff.load_llff_data(str(tmp_path / "Ballroom"), crop_size=4)
    cache = tmp_path / "Ballroom" / "images_cropped_4"
    assert sorted(os.listdir(cache)) == names
    assert all(n.lower().endswith(".jpg") for n in names)
    for i, n in enumerate(names):
        assert (cache / n).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        src = read_rgb8(str(tmp_path / "Ballroom" / "images" / n))
        crop = resize_linear(src[4:H - 4, int(4 * W / H):W - int(4 * W / H)], (H, W))
        np.testing.assert_array_equal(read_rgb8(str(cache / n)), crop)
        np.testing.assert_array_equal(imgs[i], crop.astype(np.float32) / 255.0)
