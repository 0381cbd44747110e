"""The port's PNG reader and writer and its cv2 resamplers
(nope_nerf_torch/data/image_io.py) against cv2, on the CPU.

PNG: files cv2 wrote, with each of the five row filters and with its
adaptive choice (also at V-KITTI's 375x1242), read by the port exactly as
cv2.imread reads them (BGR reversed); files the port wrote, with each
filter, read back exactly by cv2.
Resamplers: cv2 rounds uint8 results in fixed point, the port in float64 with
the same weights, so at most one step of 255 apart; each case states the
share of pixels that differ at all. Float inputs agree to f32 rounding.
"""

import cv2
import numpy as np
import pytest

from nope_nerf_torch.data import image_io

CV2_FILTERS = {0: cv2.IMWRITE_PNG_FILTER_NONE, 1: cv2.IMWRITE_PNG_FILTER_SUB,
               2: cv2.IMWRITE_PNG_FILTER_UP, 3: cv2.IMWRITE_PNG_FILTER_AVG,
               4: cv2.IMWRITE_PNG_FILTER_PAETH, "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


def _rgb(h, w, seed):
    """Smooth gradients plus noise: every filter has something to predict."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 200
    return np.clip(base + rng.normal(0, 20, size=(h, w, 3)), 0, 255).astype(np.uint8)


def _depth16(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 65536, size=(h, w), dtype=np.uint16)


@pytest.mark.parametrize("filt", list(CV2_FILTERS))
def test_reads_what_cv2_writes_exactly(tmp_path, filt):
    rgb, depth = _rgb(37, 53, 0), _depth16(29, 41, 1)
    gray = rgb[..., 1].copy()
    params = [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[filt]]
    cv2.imwrite(str(tmp_path / "rgb.png"), rgb[..., ::-1], params)
    cv2.imwrite(str(tmp_path / "depth.png"), depth, params)
    cv2.imwrite(str(tmp_path / "gray.png"), gray, params)
    got = image_io.read_png(str(tmp_path / "rgb.png"))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "rgb.png"))[..., ::-1])
    np.testing.assert_array_equal(image_io.read_rgb8(str(tmp_path / "rgb.png")), rgb)
    got16 = image_io.read_png(str(tmp_path / "depth.png"))
    assert got16.dtype == np.uint16
    np.testing.assert_array_equal(
        got16, cv2.imread(str(tmp_path / "depth.png"), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH))
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "gray.png")), gray)
    np.testing.assert_array_equal(image_io.read_rgb8(str(tmp_path / "gray.png")),
                                  cv2.imread(str(tmp_path / "gray.png"))[..., ::-1])
    assert image_io.image_shape(str(tmp_path / "rgb.png")) == (37, 53)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_cv2_reads_what_the_port_writes_exactly(tmp_path, filt):
    rgb, depth = _rgb(31, 47, 2), _depth16(23, 19, 3)
    rgba = np.concatenate([rgb, rgb[..., :1]], -1)
    image_io.write_png(str(tmp_path / "rgb.png"), rgb, filter_type=filt)
    image_io.write_png(str(tmp_path / "rgba.png"), rgba, filter_type=filt)
    image_io.write_png(str(tmp_path / "depth.png"), depth, filter_type=filt)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "rgb.png"))[..., ::-1], rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "rgba.png"), cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]], rgba)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "depth.png"), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH), depth)
    # and the port reads its own files back (the hand-filtered case of the reader)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "rgb.png")), rgb)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "rgba.png")), rgba)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "depth.png")), depth)


@pytest.mark.parametrize("filt", [3, 4, "adaptive"])
def test_reads_a_vkitti_sized_frame_exactly(tmp_path, filt):
    """A 375x1242 RGB frame with Average, Paeth or cv2's adaptive choice of
    rows: the wavefront over anti-diagonals gives cv2's bytes; the adaptive
    file mixes row filters, so each row's own predictor is picked."""
    rgb = _rgb(375, 1242, 5)
    cv2.imwrite(str(tmp_path / "a.png"), rgb[..., ::-1],
                [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[filt]])
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "a.png"))[..., ::-1])
    np.testing.assert_array_equal(image_io.read_rgb8(str(tmp_path / "a.png")), rgb)


def test_refuses_what_it_cannot_read(tmp_path):
    cv2.imwrite(str(tmp_path / "a.jpg"), _rgb(8, 8, 4))
    with pytest.raises(NotImplementedError, match="PNG"):
        image_io.read_png(str(tmp_path / "a.jpg"))
    with pytest.raises(ValueError):
        image_io.write_png(str(tmp_path / "b.png"), np.zeros((4, 4), np.float32))


# (source size, destination size): V-KITTI's 375x1242 -> 188x621 (resize_factor 2,
# not an integer factor), an integer factor of 4, and a fractional one both ways
AREA_CASES = [((375, 1242), (188, 621)), ((300, 400), (75, 100)), ((97, 131), (40, 51))]


@pytest.mark.parametrize("src,dst", AREA_CASES)
def test_resize_area_within_one_step_of_cv2(src, dst):
    img = _rgb(*src, seed=src[0])
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    got = image_io.resize_area(img, dst)
    diff = np.abs(got.astype(int) - ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert diff.max() <= 1
    # measured: below 0.1% of the values differ at all
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


# the crop path: a border crop of crop_size rows (and crop_size * W / H columns)
# resized back to the full size; and a float depth map, bilinearly (load_depths_npz)
@pytest.mark.parametrize("shape,crop", [((60, 200), 4), ((375, 1242), 20)])
def test_resize_linear_within_one_step_of_cv2(shape, crop):
    img = _rgb(*shape, seed=crop)
    h0, w0 = shape
    cw = int(crop * w0 / h0)
    cropped = img[crop:h0 - crop, cw:w0 - cw]
    ref = cv2.resize(cropped, (w0, h0), interpolation=cv2.INTER_LINEAR)
    got = image_io.resize_linear(cropped, (h0, w0))
    diff = np.abs(got.astype(int) - ref)
    assert diff.max() <= 1
    # measured: about 13% of the values differ by one step (cv2's 11-bit
    # fixed-point weights), none by more
    assert (diff > 0).mean() < 0.2, (diff > 0).mean()


@pytest.mark.parametrize("src,dst", [((40, 60), (70, 90)), ((48, 64), (24, 32)), ((30, 50), (17, 23))])
def test_resize_linear_float_matches_cv2(src, dst):
    d = np.random.default_rng(0).uniform(0.5, 20.0, size=src).astype(np.float32)
    ref = cv2.resize(d, (dst[1], dst[0]))
    got = image_io.resize_linear(d, dst)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((375, 1242), (188, 621)), ((60, 200), (30, 100)),
                                     ((52, 174), (30, 100))])
def test_resize_nearest_exact_matches_cv2_at_loader_sizes(src, dst):
    rng = np.random.default_rng(src[1])
    d = rng.uniform(0, 80, size=src).astype(np.float32)
    m = (d > 40).astype(np.uint8)
    for a in (d, m):
        np.testing.assert_array_equal(
            image_io.resize_nearest_exact(a, dst),
            cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST_EXACT))
