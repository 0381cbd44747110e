"""The port's JPEG reader (nope_nerf_torch/data/jpeg.py through
data/image_io.py) against cv2.imread, and the test-side JPEG writer
(nope_nerf_torch/tools/jpeg_writer.py), on the CPU.

Files come from cv2.imwrite and PIL (both libjpeg-turbo here): every
sampling mode cv2 writes (4:4:4, 4:2:2, 4:4:0, 4:2:0, 4:1:1), qualities 50
to 100, random and smooth content, odd sizes, restart intervals, gray,
progressive and optimised-Huffman files, and Exif orientations 1-8. Each is
read by `read_rgb8` bit-equal (np.array_equal) to cv2.imread(p)[..., ::-1],
and `image_shape` gives cv2's shape from the headers alone. The formats the
port does not read raise NotImplementedError naming the format. Every mode
of the writer decodes to the same bytes in cv2 and in the port. cv2 and PIL
are the oracle: the machine with the card has neither.
"""

import struct
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from nope_nerf_torch.data import image_io, jpeg                    # noqa: E402
from nope_nerf_torch.tools import jpeg_writer                      # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _rgb(h, w, seed, smooth):
    """Smooth gradients with a little noise, or uniform noise (every
    coefficient busy, the IDCT's range limit reached)."""
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 200 + 30 * np.sin(20 * xx)[..., None]
    return np.clip(base + rng.normal(0, 6, size=(h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_write(path, rgb, quality=95, sampling="420", *extra):
    ok = cv2.imwrite(str(path), np.ascontiguousarray(rgb[..., ::-1]) if rgb.ndim == 3 else rgb,
                     [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                      SAMPLING[sampling], *extra])
    assert ok


def _check(path):
    """read_rgb8 and image_shape against cv2 on one file."""
    ref = cv2.imread(str(path))[..., ::-1]
    got = image_io.read_rgb8(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert image_io.image_shape(str(path)) == ref.shape[:2]
    return got


@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "random"])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_sampling_and_quality(tmp_path, sampling, quality, smooth):
    _cv2_write(tmp_path / "a.jpg", _rgb(37, 53, quality, smooth), quality, sampling)
    _check(tmp_path / "a.jpg")


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (375, 1242)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_odd_sizes(tmp_path, size, sampling):
    _cv2_write(tmp_path / "a.jpg", _rgb(*size, seed=3, smooth=size[0] > 100), 95, sampling)
    _check(tmp_path / "a.jpg")


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_restart_intervals(tmp_path, sampling, interval):
    _cv2_write(tmp_path / "a.jpg", _rgb(45, 77, interval, smooth=False), 90, sampling,
               cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    assert b"\xff\xdd" in (tmp_path / "a.jpg").read_bytes()
    _check(tmp_path / "a.jpg")


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_gray(tmp_path, quality, progressive):
    gray = _rgb(29, 43, quality, smooth=quality % 2 == 1)[..., 1].copy()
    _cv2_write(tmp_path / "a.jpg", gray, quality, "444", cv2.IMWRITE_JPEG_PROGRESSIVE,
               int(progressive))
    got = _check(tmp_path / "a.jpg")
    assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "random"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_progressive_cv2(tmp_path, sampling, smooth):
    _cv2_write(tmp_path / "a.jpg", _rgb(41, 67, 5, smooth), 90, sampling,
               cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    assert b"\xff\xc2" in (tmp_path / "a.jpg").read_bytes()
    _check(tmp_path / "a.jpg")


@pytest.mark.parametrize("optimize", [False, True], ids=["standard", "optimized"])
@pytest.mark.parametrize("quality", [60, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_pil(tmp_path, subsampling, quality, optimize):
    Image.fromarray(_rgb(67, 93, subsampling, smooth=quality > 90)).save(
        tmp_path / "a.jpg", quality=quality, progressive=True, subsampling=subsampling,
        optimize=optimize)
    _check(tmp_path / "a.jpg")


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_optimized_huffman(tmp_path, sampling, progressive):
    _cv2_write(tmp_path / "a.jpg", _rgb(55, 81, 8, smooth=True), 85, sampling,
               cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive))
    _check(tmp_path / "a.jpg")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(_rgb(24, 40, orientation, smooth=True)).save(
        tmp_path / "a.jpg", quality=90, exif=exif.tobytes())
    got = _check(tmp_path / "a.jpg")
    assert got.shape[:2] == ((40, 24) if orientation >= 5 else (24, 40))
    # the same pixels without the transform, as cv2 reads them ignoring the tag
    plain = cv2.imread(str(tmp_path / "a.jpg"), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    np.testing.assert_array_equal(jpeg._orient(plain[..., ::-1], orientation), got)


def test_rgb_components(tmp_path):
    """A 3-component file that an Adobe marker (transform 0) declares RGB: no
    colour conversion, as libjpeg decides from the markers."""
    Image.fromarray(_rgb(20, 30, 9, smooth=False)).save(tmp_path / "a.jpg", quality=90,
                                                        keep_rgb=True)
    assert b"Adobe" in (tmp_path / "a.jpg").read_bytes()
    _check(tmp_path / "a.jpg")


def _frame_header(path):
    """(the bytes of a JPEG file, the offset of its SOFn marker)."""
    data = path.read_bytes()
    pos = 2
    while True:
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data, pos
        pos += 2 + length


@pytest.mark.parametrize("marker,name", [(0xC9, "arithmetic"), (0xCA, "arithmetic"),
                                         (0xC3, "lossless"), (0xC5, "hierarchical")])
def test_refuses_other_codings(tmp_path, marker, name):
    """A baseline file whose SOF0 is turned into another coding's SOFn (the
    reader stops at the frame header, so the scan's coding is moot)."""
    _cv2_write(tmp_path / "a.jpg", _rgb(16, 16, 0, True))
    data, pos = _frame_header(tmp_path / "a.jpg")
    (tmp_path / "b.jpg").write_bytes(data[:pos + 1] + bytes([marker]) + data[pos + 2:])
    for fn in (image_io.read_rgb8, image_io.image_shape):
        with pytest.raises(NotImplementedError, match=name):
            fn(str(tmp_path / "b.jpg"))


def test_refuses_12_bit_and_cmyk(tmp_path):
    _cv2_write(tmp_path / "a.jpg", _rgb(16, 16, 0, True))
    data, pos = _frame_header(tmp_path / "a.jpg")
    (tmp_path / "b.jpg").write_bytes(data[:pos + 4] + bytes([12]) + data[pos + 5:])
    with pytest.raises(NotImplementedError, match="12-bit"):
        image_io.read_rgb8(str(tmp_path / "b.jpg"))
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(tmp_path / "c.jpg", quality=90)
    with pytest.raises(NotImplementedError, match="CMYK"):
        image_io.read_rgb8(str(tmp_path / "c.jpg"))


def test_format_from_the_signature(tmp_path):
    rgb = _rgb(20, 30, 1, True)
    (tmp_path / "jpeg.png").write_bytes(cv2.imencode(".jpg", rgb[..., ::-1])[1].tobytes())
    image_io.write_png(str(tmp_path / "png.jpg"), rgb)
    np.testing.assert_array_equal(image_io.read_rgb8(str(tmp_path / "jpeg.png")),
                                  cv2.imread(str(tmp_path / "jpeg.png"))[..., ::-1])
    np.testing.assert_array_equal(image_io.read_rgb8(str(tmp_path / "png.jpg")), rgb)
    assert image_io.image_shape(str(tmp_path / "jpeg.png")) == (20, 30)
    assert image_io.image_shape(str(tmp_path / "png.jpg")) == (20, 30)
    (tmp_path / "x.jpg").write_bytes(b"GIF89a" + bytes(64))
    with pytest.raises(NotImplementedError, match="neither PNG nor JPEG"):
        image_io.read_rgb8(str(tmp_path / "x.jpg"))


def test_truncated_scan_raises(tmp_path):
    _cv2_write(tmp_path / "a.jpg", _rgb(64, 64, 2, False))
    data = (tmp_path / "a.jpg").read_bytes()
    (tmp_path / "b.jpg").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError):
        image_io.read_rgb8(str(tmp_path / "b.jpg"))


def test_writer_tables_are_annex_k():
    """The writer's Huffman tables are the ones cv2 writes by default, its
    quantisation tables libjpeg's at each quality."""
    rgb = _rgb(16, 16, 0, True)
    for quality in (50, 75, 95):
        ok, buf = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_QUALITY, quality])
        data = buf.tobytes()
        frame_tables, pos = {}, 2
        while data[pos + 1] != 0xDA:
            marker = data[pos + 1]
            (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
            body = data[pos + 4:pos + 2 + length]
            i = 0
            while i < len(body) and marker == 0xC4:
                n = sum(body[i + 1:i + 17])
                frame_tables[("dht", body[i])] = (body[i + 1:i + 17], body[i + 17:i + 17 + n])
                i += 17 + n
            while i < len(body) and marker == 0xDB:
                frame_tables[("dqt", body[i])] = np.frombuffer(body[i + 1:i + 65], np.uint8)
                i += 65
            pos += 2 + length
        assert frame_tables[("dht", 0x00)] == jpeg_writer.DC_LUMA
        assert frame_tables[("dht", 0x10)] == jpeg_writer.AC_LUMA
        assert frame_tables[("dht", 0x01)] == jpeg_writer.DC_CHROMA
        assert frame_tables[("dht", 0x11)] == jpeg_writer.AC_CHROMA
        np.testing.assert_array_equal(
            frame_tables[("dqt", 0)], jpeg_writer.quant_table(jpeg_writer.LUMA_Q, quality)[jpeg.ZIGZAG])
        np.testing.assert_array_equal(
            frame_tables[("dqt", 1)],
            jpeg_writer.quant_table(jpeg_writer.CHROMA_Q, quality)[jpeg.ZIGZAG])


@pytest.mark.parametrize("orientation", [None, 1, 6, 3])
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", sorted(jpeg_writer.SAMPLING))
def test_writer_decodes_alike_in_cv2_and_the_port(tmp_path, sampling, restart, orientation):
    rgb = _rgb(45, 70, restart, smooth=True)
    path = str(tmp_path / "w.jpg")
    jpeg_writer.write_jpeg(path, rgb, quality=95, sampling=sampling, restart_interval=restart,
                           orientation=orientation)
    got = _check(tmp_path / "w.jpg")
    upright = jpeg._orient(got, {None: 1, 1: 1, 6: 8, 3: 3}[orientation])
    assert upright.shape == rgb.shape
    # within the writer's quantisation error of the source: luma at full
    # resolution, chroma over the cells it was averaged on
    assert jpeg_writer.kept_psnr(upright, rgb, sampling) > 35.0


def test_decode_times(tmp_path):
    """Times on this machine, printed (pytest -s), not asserted: a 540x960
    q95 4:2:0 frame as cv2 writes it and as the port's writer writes it, and a
    375x1242 frame cv2 writes with its adaptive PNG filters."""
    rgb = _rgb(540, 960, 0, smooth=True)
    _cv2_write(tmp_path / "cv2.jpg", rgb, 95, "420")
    jpeg_writer.write_jpeg(str(tmp_path / "port.jpg"), rgb, 95, "4:2:0")
    png = _rgb(375, 1242, 1, smooth=True)
    cv2.imwrite(str(tmp_path / "a.png"), png[..., ::-1],
                [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    times = {}
    for name, fn in (("cv2.jpg", image_io.read_rgb8), ("port.jpg", image_io.read_rgb8),
                     ("a.png", image_io.read_png)):
        t0 = time.perf_counter()
        fn(str(tmp_path / name))
        times[name] = (time.perf_counter() - t0) * 1e3
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "a.png")), png)
    print(f"decode ms: 540x960 q95 4:2:0 JPEG (cv2) {times['cv2.jpg']:.1f}, (writer) "
          f"{times['port.jpg']:.1f}; 375x1242 adaptive PNG (cv2) {times['a.png']:.1f}")
