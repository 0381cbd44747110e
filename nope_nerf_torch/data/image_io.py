"""PNG files and the image resamplers the scene loader needs, on zlib and numpy.

The JAX package reads and resizes scene images with cv2 (nope_nerf_tpu/data/
llff.py). The port keeps its own versions, since the machine with the card
has no cv2, imageio or PIL:

- `read_png` / `write_png`: 8-bit gray, gray+alpha, RGB and RGBA, and 16-bit
  of each (16-bit samples are big-endian in the file). The reader undoes all
  five row filters: None, Sub and Up are vectorised over a row; Average and
  Paeth depend on the pixel to the left once it is decoded, so they run a
  loop over the bytes of a row (about a second for a 375x1242 RGB image that
  is Paeth-filtered throughout, as cv2's adaptive writer may do). The writer
  takes any of the five filters, vectorised over the whole image (the
  forward filter reads only the original pixels), and defaults to Up, so
  the files the port writes decode without the loop. Colour comes back and
  goes in as RGB; cv2 reads and writes BGR. Interlaced and palette files are
  refused.
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
        raise NotImplementedError(f"{path}: not a PNG file; the port reads PNG images only "
                                  "(convert JPEG scenes to PNG first)")
    kind, body = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR")
    return struct.unpack(">IIBBBBB", body)


def image_shape(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file from its header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    w, h = _header(head, path)[:2]
    return h, w


def _paeth(a, b, c):
    """The Paeth predictor of each byte from its left (a), upper (b) and
    upper-left (c) neighbours: elementwise on arrays or on ints."""
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    if isinstance(pa, np.ndarray):
        return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return line
    if kind == 1:   # Sub: a running sum along the row, per byte of the pixel
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:   # Up
        return line + prev
    cur, up = line.tolist(), prev.tolist()
    if kind == 3:   # Average of the decoded left byte and the upper byte
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(len(cur)):
            if i >= bpp:
                pred = _paeth(cur[i - bpp], up[i], up[i - bpp])
            else:
                pred = up[i]
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"unknown PNG row filter {kind}")
    return np.asarray(cur, np.uint8)


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
    rows = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for r in range(h):
        prev = rows[r] = _unfilter_row(int(raw[r, 0]), raw[r, 1:], prev, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, what cv2.imread(path, IMREAD_COLOR) gives with its
    channels reversed: gray is repeated, alpha dropped, 16 bits cut to 8."""
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

