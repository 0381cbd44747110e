"""Image files (PNG both ways, JPEG read) and the resamplers the scene loader
needs, on zlib and numpy.

The JAX package reads and resizes scene images with cv2 (nope_nerf_tpu/data/
llff.py). The port keeps its own versions, since the machine with the card
has no cv2, imageio or PIL:

- `read_rgb8` / `image_shape` take the format from the file's first bytes,
  as cv2 does, not from its name: PNG, or JPEG through data/jpeg.py
  (`read_jpeg`, baseline and progressive, bit-equal to cv2.imread with its
  Exif orientation applied).
- `read_png` / `write_png`: 8-bit gray, gray+alpha, RGB and RGBA, and 16-bit
  of each (16-bit samples are big-endian in the file). The reader undoes all
  five row filters: None, Sub and Up row by row, vectorised over a row; a
  file with Average or Paeth rows, whose bytes depend on the decoded pixel
  to their left, as a wavefront over the image's anti-diagonals, every row
  at once (row r's pixel x is decoded at step r + x, after its left, upper
  and upper-left neighbours). The writer takes any of the five filters,
  vectorised over the whole image (the forward filter reads only the
  original pixels), and defaults to Up. Colour comes back and goes in as
  RGB; cv2 reads and writes BGR. Interlaced and palette files are refused.
- `resize_area` (cv2.INTER_AREA, downscaling), `resize_linear`
  (cv2.INTER_LINEAR), `resize_cubic` (cv2.INTER_CUBIC, which the DPT input
  transform uses on float32 images) and `resize_nearest_exact`
  (cv2.INTER_NEAREST_EXACT), each taking the output size as (height, width),
  where cv2 takes (width, height).

cv2 computes uint8 results in fixed point or single precision, the port in
float64 with the same weights, rounded to nearest. A uint8 result may so
differ from cv2's by one step (1/255) on some pixels; float inputs agree to
float32 rounding. `resize_nearest_exact` picks the same source pixels as cv2
at the sizes of the shipped configurations (375x1242 -> 188x621, and every
size the tests try); where (dst + 0.5) * src_len / dst_len is an exact
integer, cv2's fixed-point rounding lands one pixel lower at some sizes
(400 -> 54 at dst 13), which the port does not reproduce.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

from .jpeg import SOI, decode_jpeg, jpeg_shape

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}           # PNG colour type -> samples per pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _header(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise NotImplementedError(f"{path}: not a PNG file (read_rgb8 and image_shape read "
                                  "JPEG files too)")
    kind, body = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR")
    return struct.unpack(">IIBBBBB", body)


def image_shape(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG or JPEG file from its headers alone, as
    cv2.imread would return it (a JPEG's Exif orientation applied)."""
    with open(path, "rb") as f:
        head = f.read(33)
        if head[:2] == SOI:
            return jpeg_shape(head + f.read(), path)
    w, h = _header(head, path)[:2]
    return h, w


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file: cv2.imread(path, IMREAD_COLOR)
    with its channels reversed, bit for bit (data/jpeg.py)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def _unfilter_rows(raw: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered with None, Sub or Up only: one row at a time, each
    vectorised over its bytes."""
    rows = np.empty_like(raw)
    prev = np.zeros(raw.shape[1], np.uint8)
    for r, kind in enumerate(kinds.tolist()):
        line = raw[r]
        if kind == 1:   # Sub: a running sum along the row, per byte of the pixel
            line = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            line = line + prev
        prev = rows[r] = line
    return rows


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of each byte from its left (a), upper (b) and
    upper-left (c) neighbours, on int16 arrays: whichever of a, b, c is
    nearest a + b - c, in that order on ties."""
    d1, d2 = b - c, a - c
    pa, pb = np.abs(d1), np.abs(d2)
    d1 += d2
    pc = np.abs(d1, out=d1)
    pred = np.where(pb <= pc, b, c)
    return np.where(pa <= np.minimum(pb, pc, out=pc), a, pred)


# each row filter's predictor from (left, upper, upper-left)
_PREDICTORS = (lambda a, b, c: 0, lambda a, b, c: a, lambda a, b, c: b,
               lambda a, b, c: (a + b) >> 1, _paeth)


def _skewed(work: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """The (h, w, bpp) view of a wavefront work array (h + w + 1, h + 1, bpp)
    in which row r's pixel x sits at [r + x + 2, r + 1]."""
    s = work.itemsize
    return np.lib.stride_tricks.as_strided(
        work[2:, 1:], shape=(h, w, bpp), strides=((h + 2) * bpp * s, (h + 1) * bpp * s, s),
        writeable=True)


def _unfilter_wavefront(raw: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Rows with any of the five filters. Pixel x of row r depends on its left,
    upper and upper-left neighbours only, so every pixel of the anti-diagonal
    r + x = t is decoded at step t, all rows at once: h + w - 1 steps of
    vectorised work instead of a loop over the bytes. The work arrays hold
    anti-diagonal t at index t + 2 of their first axis (row r at r + 1 of the
    second), so the neighbours of step t are the slices t + 1 (left, upper)
    and t (upper-left), with zeros before the first row and column. Only the
    predictors of the filters the file uses are formed."""
    h, n = raw.shape
    w = n // bpp
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    filtered = np.zeros_like(out)
    _skewed(filtered, h, w, bpp)[...] = raw.reshape(h, w, bpp)
    used = sorted(set(kinds.tolist()))
    predictors = [_PREDICTORS[k] for k in used]
    slot = np.searchsorted(used, kinds)[:, None]          # each row's predictor
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t) + 1
        a, b, c = out[t + 1, r0 + 1:r1 + 1], out[t + 1, r0:r1], out[t, r0:r1]
        if len(predictors) == 1:
            pred = predictors[0](a, b, c)
        else:
            pred = np.choose(slot[r0:r1], [f(a, b, c) for f in predictors])
        dst = out[t + 2, r0 + 1:r1 + 1]
        np.add(filtered[t + 2, r0 + 1:r1 + 1], pred, out=dst)
        dst &= 0xFF
    return _skewed(out, h, w, bpp).astype(np.uint8).reshape(h, n)


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG file: (H, W) for gray, else (H, W, C) with C the
    file's channels in its order (RGB, RGBA), as uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, ctype, _, _, interlace = _header(data, path)
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(f"{path}: PNG colour type {ctype}, bit depth {depth}, "
                                  f"interlace {interlace} is not read by the port")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = zlib.decompress(b"".join(body for kind, body in _chunks(data) if kind == b"IDAT"))
    raw = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {kinds.max()}")
    unfilter = _unfilter_wavefront if (kinds >= 3).any() else _unfilter_rows
    rows = unfilter(raw[:, 1:], kinds, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, what cv2.imread(path, IMREAD_COLOR) gives with its
    channels reversed: gray is repeated, alpha dropped, 16 bits cut to 8. The
    format is the file's (PNG or JPEG), whatever its name says."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:2] == SOI:
        return read_jpeg(path)
    if head != _SIGNATURE:
        raise NotImplementedError(f"{path}: neither PNG nor JPEG; the port reads those two "
                                  "formats only")
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _filter(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """The forward row filter over every row at once: it reads the original
    bytes only, so it vectorises."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        pred = _paeth(left, up, upleft)
    else:
        raise ValueError(f"unknown PNG row filter {kind}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Write (H, W) gray or (H, W, C) gray+alpha / RGB / RGBA samples, uint8 or
    uint16, as a PNG file, every row with `filter_type` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16 samples, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, channels = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    bpp = channels * depth // 8
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), _filter(rows, bpp, filter_type)],
                         axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


# ---- resamplers ------------------------------------------------------------------

def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of cv2's INTER_AREA for a downscale
    (computeResizeAreaTab): each output pixel averages the source cells its
    footprint covers, the cut cells at either end by the covered fraction."""
    scale = src / dst
    w = np.zeros((dst, src))
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        w[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of cv2's INTER_LINEAR: half-pixel centres,
    src = (dst + 0.5) * scale - 0.5, the two neighbours clamped at the edges."""
    scale = src / dst
    w = np.zeros((dst, src))
    for dx in range(dst):
        fx = (dx + 0.5) * scale - 0.5
        sx = math.floor(fx)
        fx -= sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= src - 1:
            fx, sx = 0.0, src - 1
        w[dx, sx] += 1.0 - fx
        if fx:
            w[dx, sx + 1] += fx
    return w


def _cubic_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of cv2's INTER_CUBIC: Keys' cubic with A = -0.75 on
    half-pixel centres, the four taps' indices clamped at the edges. cv2 (5.0)
    places the taps and forms the coefficients in double and keeps them as
    float32 for a float image; so does this."""
    a = -0.75
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx)
    x = fx - sx
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    w = np.zeros((dst, src))
    rows = np.arange(dst)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(w, (rows, np.clip(sx.astype(np.int64) - 1 + k, 0, src - 1)),
                  c.astype(np.float32))
    return w


def _apply(img: np.ndarray, wy: np.ndarray, wx: np.ndarray, half_up: bool = False
           ) -> np.ndarray:
    out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))        # (oh, w, ...)
    out = np.moveaxis(np.tensordot(out, wx, axes=(1, 1)), -1, 1)       # (oh, ow, ...)
    if img.dtype in (np.uint8, np.uint16):
        # to nearest, ties to even as cvRound; cv2's 2x2 box sums round ties up
        out = np.floor(out + 0.5) if half_up else np.rint(out)
        return np.clip(out, 0, np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> size = (h, w), no larger, by cv2.INTER_AREA's box weights
    (fractional at the footprint's ends when H/h or W/w is no integer)."""
    h, w = img.shape[:2]
    if size[0] > h or size[1] > w:
        raise NotImplementedError("resize_area downscales only (cv2's INTER_AREA upscale is "
                                  "another interpolation)")
    return _apply(img, _area_weights(h, size[0]), _area_weights(w, size[1]),
                  half_up=(h, w) == (2 * size[0], 2 * size[1]))


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> size = (h, w) by cv2.INTER_LINEAR, including its switch
    to INTER_AREA for an exact halving of both sides."""
    h, w = img.shape[:2]
    if (h, w) == (2 * size[0], 2 * size[1]):
        return resize_area(img, size)
    return _apply(img, _linear_weights(h, size[0]), _linear_weights(w, size[1]))


def resize_cubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> size = (h, w) by cv2.INTER_CUBIC, up or down (four taps
    either way, as cv2). cv2 resizes a float image in float32 arithmetic; the
    port sums in float64 over the same float32 weights, so the two agree to
    float32 rounding. A uint8 image is rounded to nearest, where cv2's fixed
    point may land one step away."""
    h, w = img.shape[:2]
    return _apply(img, _cubic_weights(h, size[0]), _cubic_weights(w, size[1]))


def resize_nearest_exact(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> (size[0], size[1][, C]) by cv2.INTER_NEAREST_EXACT's rule:
    the source pixel under the centre of each destination pixel,
    src = floor((dst + 0.5) * src_len / dst_len)."""
    h, w = img.shape[:2]
    oh, ow = size
    iy = np.minimum(np.floor((np.arange(oh) + 0.5) * (h / oh)).astype(np.int64), h - 1)
    ix = np.minimum(np.floor((np.arange(ow) + 0.5) * (w / ow)).astype(np.int64), w - 1)
    return img[iy[:, None], ix[None, :]]

