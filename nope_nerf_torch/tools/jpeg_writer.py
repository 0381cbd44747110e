"""A baseline JPEG writer, for tests and chip_smoke.py: the machine with the
card has no cv2 or PIL to put JPEG frames on disk. No load path imports it.

`write_jpeg(path, rgb, quality, sampling, restart_interval, orientation)`
writes an (H, W, 3) uint8 RGB image as a JFIF baseline file (SOF0): the
JFIF colour transform in float, chroma averaged over each 2x1 or 2x2 cell
for 4:2:2 and 4:2:0 (the image padded to whole MCUs by repeating its last
row and column), a float FDCT, the Annex K.1 quantisation tables scaled by
quality as libjpeg's jpeg_quality_scaling does, the Annex K.3 Huffman
tables, an optional restart interval (DRI + RSTn) and an optional Exif
orientation tag in an APP1 segment. The entropy coder is vectorised over
the whole image; its bytes need not equal cv2's, only decode the same.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..data.jpeg import ZIGZAG

SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}   # luma (h, v)

# JFIF's RGB -> YCbCr (Cb and Cr then offset by 128)
YCBCR = np.array([[0.299, 0.587, 0.114], [-0.168735892, -0.331264108, 0.5],
                  [0.5, -0.418687589, -0.081312411]])
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                   14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                   18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                             24, 26, 56, 47, 66]

# Annex K.3: (counts of codes of each length 1..16, symbols)
DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))

AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline):
    the base table scaled by 5000 / q below 50, 200 - 2 q from 50 on,
    rounded, clamped to [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(table):
    """symbol -> (code, length) of a DHT table (counts, symbols)."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    length_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code_of[symbols[k]], length_of[symbols[k]] = code, n
            code += 1
            k += 1
        code <<= 1
    return code_of, length_of


def _fdct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, which is JPEG's FDCT in each axis."""
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def _blocks(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(rows, cols) samples, both multiples of 8 -> quantised coefficients
    (rows / 8, cols / 8, 64) in zigzag order."""
    r, c = plane.shape
    x = plane.reshape(r // 8, 8, c // 8, 8).transpose(0, 2, 1, 3) - 128.0
    d = _fdct_matrix()
    coef = np.einsum("ui,abij,vj->abuv", d, x, d).reshape(r // 8, c // 8, 64)
    return np.rint(coef / qt)[..., ZIGZAG].astype(np.int64)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's size category) and the value's extra bits."""
    mag = np.abs(v)
    size = np.zeros_like(v)
    nz = mag > 0
    size[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    return size, np.where(v >= 0, v, v + (1 << size) - 1)


def _entropy_code(zz: np.ndarray, comp: np.ndarray, tables, restart_every: int):
    """Bytes of the scan, stuffed, with RSTn between restart segments. zz:
    (n_blocks, 64) zigzag coefficients in decode order; comp: each block's
    component (0 luma, 1 and 2 chroma); tables: per component ((DC codes,
    lengths), (AC codes, lengths)); restart_every: blocks per segment, 0 for
    none."""
    n = len(zz)
    seg = np.arange(n) // restart_every if restart_every else np.zeros(n, np.int64)
    # DC differences against the previous block of the same component, reset
    # at each restart segment
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        if not len(idx):
            continue
        prev = np.concatenate([[0], dc[idx[:-1]]])
        first = np.concatenate([[True], seg[idx[1:]] != seg[idx[:-1]]])
        diff[idx] = dc[idx] - np.where(first, 0, prev)
    keys, vals, lens = [], [], []
    blocks = np.arange(n)
    size, bits = _size(diff)
    dc_code = np.empty(n, np.int64)
    dc_len = np.empty(n, np.int64)
    for c in range(3):
        m = comp == c
        code_of, length_of = tables[c][0]
        dc_code[m], dc_len[m] = code_of[size[m]], length_of[size[m]]
    keys.append(blocks * 256)
    vals.append((dc_code << size) | bits)
    lens.append(dc_len + size)
    # AC: each nonzero coefficient, the ZRLs before it, an EOB after the last
    # unless it sits at position 63
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    new_block = np.concatenate([[True], b[1:] != b[:-1]])
    prev_k = np.where(new_block, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    zrl, run = run // 16, run % 16
    size, bits = _size(v)
    sym = (run << 4) | size
    ac = [tables[c][1] for c in range(3)]
    code = np.empty(len(b), np.int64)
    length = np.empty(len(b), np.int64)
    zrl_code = np.empty(len(b), np.int64)
    zrl_len = np.empty(len(b), np.int64)
    for c in range(3):
        m = comp[b] == c
        code[m], length[m] = ac[c][0][sym[m]], ac[c][1][sym[m]]
        zrl_code[m], zrl_len[m] = ac[c][0][0xF0], ac[c][1][0xF0]
    keys.append(b * 256 + 2 * k + 1)
    vals.append((code << size) | bits)
    lens.append(length + size)
    zb = np.repeat(np.arange(len(b)), zrl)
    keys.append(b[zb] * 256 + 2 * k[zb])
    vals.append(zrl_code[zb])
    lens.append(zrl_len[zb])
    last = np.full(n, 0)
    last[b] = k                                  # b ascends, so the last write wins
    eob = np.flatnonzero(last < 63)
    eob_code = np.array([ac[c][0][0] for c in range(3)])[comp[eob]]
    eob_len = np.array([ac[c][1][0] for c in range(3)])[comp[eob]]
    keys.append(eob * 256 + 255)
    vals.append(eob_code)
    lens.append(eob_len)
    keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    keys, vals, lens = keys[order], vals[order], lens[order]
    n_seg = int(seg[-1]) + 1 if n else 0
    cuts = np.searchsorted(seg[keys // 256], np.arange(n_seg + 1))
    parts = []
    for s in range(n_seg):
        if s:
            parts.append(bytes([0xFF, 0xD0 + (s - 1) % 8]))
        parts.append(_pack(vals[cuts[s]:cuts[s + 1]], lens[cuts[s]:cuts[s + 1]]))
    return b"".join(parts)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """The codes' bits, most significant first, padded with 1 bits to a
    byte, each 0xFF byte followed by a stuffed 0x00."""
    total = int(lens.sum())
    start = np.cumsum(lens) - lens
    owner = np.repeat(np.arange(len(vals)), lens)
    shift = lens[owner] - 1 - (np.arange(total) - start[owner])
    bits = (vals[owner] >> shift) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _exif(orientation: int) -> bytes:
    """An APP1 Exif body whose IFD0 holds only the orientation tag."""
    ifd = struct.pack(">HHHIHHI", 1, 0x0112, 3, 1, orientation, 0, 0)
    return b"Exif\x00\x00" + b"MM\x00\x2a" + struct.pack(">I", 8) + ifd


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95, sampling: str = "4:2:0",
               restart_interval: int = 0, orientation: Optional[int] = None) -> None:
    """Write (H, W, 3) uint8 RGB to `path` as a baseline JFIF file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("write_jpeg takes (H, W, 3) uint8 RGB")
    if sampling not in SAMPLING:
        raise ValueError(f"sampling is one of {sorted(SAMPLING)}, got {sampling!r}")
    h, w = rgb.shape[:2]
    hs, vs = SAMPLING[sampling]
    mcu_cols, mcu_rows = -(-w // (8 * hs)), -(-h // (8 * vs))
    full = np.pad(rgb.astype(np.float64),
                  ((0, mcu_rows * 8 * vs - h), (0, mcu_cols * 8 * hs - w), (0, 0)), mode="edge")
    y, cb, cr = np.moveaxis(full @ YCBCR.T + [0, 128, 128], -1, 0)

    def down(x):
        return x.reshape(x.shape[0] // vs, vs, x.shape[1] // hs, hs).mean(axis=(1, 3))

    qy, qc = quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)
    ycoef = _blocks(y, qy)                                   # (rows, cols, 64)
    # the MCU order: each MCU's vs x hs luma blocks, then Cb, then Cr
    ymcu = ycoef.reshape(mcu_rows, vs, mcu_cols, hs, 64).transpose(0, 2, 1, 3, 4)
    ymcu = ymcu.reshape(mcu_rows * mcu_cols, vs * hs, 64)
    cbmcu = _blocks(down(cb), qc).reshape(-1, 1, 64)
    crmcu = _blocks(down(cr), qc).reshape(-1, 1, 64)
    zz = np.concatenate([ymcu, cbmcu, crmcu], axis=1)
    per_mcu = zz.shape[1]
    comp = np.tile(np.array([0] * (vs * hs) + [1, 2]), mcu_rows * mcu_cols)
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA))] + [(_codes(DC_CHROMA), _codes(AC_CHROMA))] * 2
    scan = _entropy_code(zz.reshape(-1, 64), comp, tables, restart_interval * per_mcu)

    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if orientation is not None:
        out += _segment(0xE1, _exif(orientation))
    out += _segment(0xDB, bytes([0]) + bytes(qy[ZIGZAG].tolist())
                    + bytes([1]) + bytes(qc[ZIGZAG].tolist()))
    out += _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                    + bytes([1, (hs << 4) | vs, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls_id, (counts, symbols) in ((0x00, DC_LUMA), (0x10, AC_LUMA),
                                      (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        out += _segment(0xC4, bytes([cls_id]) + counts + symbols)
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    with open(path, "wb") as f:
        f.write(out + scan + b"\xff\xd9")


def kept_psnr(decoded: np.ndarray, source: np.ndarray, sampling: str) -> float:
    """PSNR in dB of a decoded image against its source over what a JPEG
    keeps: luma at every pixel, Cb and Cr averaged over the chroma cell of
    `sampling` (the cells the writer averaged them on), in float YCbCr. Plain
    RGB PSNR would charge the subsampling itself to the codec."""
    hs, vs = SAMPLING[sampling]
    h, w = source.shape[0] // vs * vs, source.shape[1] // hs * hs
    a = decoded[:h, :w].astype(np.float64) @ YCBCR.T
    b = source[:h, :w].astype(np.float64) @ YCBCR.T

    def cells(x):
        return x.reshape(h // vs, vs, w // hs, hs).mean(axis=(1, 3))

    err = [((a[..., 0] - b[..., 0]) ** 2).ravel()]
    err += [((cells(a[..., k]) - cells(b[..., k])) ** 2).ravel() for k in (1, 2)]
    return float(10 * np.log10(255.0 ** 2 / max(np.concatenate(err).mean(), 1e-12)))
