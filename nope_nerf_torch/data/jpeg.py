"""JPEG decoding in numpy, bit-equal to cv2.imread(path, IMREAD_COLOR).

The JAX package reads JPEG scene images with cv2 (nope_nerf_tpu/data/
llff.py); the machine with the card has no cv2, PIL or imageio, so the port
decodes them itself. cv2 decodes through libjpeg-turbo with its defaults,
and this module reproduces each stage of that:

- markers: SOI, APPn (the first APP1 carries the Exif orientation), DQT (8-
  and 16-bit tables), DHT, DRI, SOF0/SOF1 (baseline and extended sequential
  Huffman) and SOF2 (progressive Huffman), SOS, RSTn, EOI. Arithmetic coding,
  lossless and hierarchical frames, 12-bit samples and 4-component (CMYK /
  YCCK) files raise NotImplementedError naming the format;
- entropy decoding, the one serial stage: the scan is de-stuffed (FF00 and
  RSTn taken out, each restart segment's start recorded), the 16-bit window
  at every bit offset is formed at once in numpy, and each Huffman table
  becomes a 2^16-entry list of (bits used, zero run, value) with the value's
  extra bits already folded in where code and extra bits fit in 16 bits, so
  a coefficient costs one list lookup (a second one, through the symbol
  table, where they do not). Coefficients go into one Python list in zigzag
  order: progressive refinement scans read them back;
- after entropy decoding every stage is vectorised over all blocks:
  dequantisation and de-zigzag, jidctint's ISLOW IDCT (13-bit constants,
  pass-1 descale by 11 bits, pass-2 by 18, the post-IDCT range-limit table
  indexed by the low 10 bits), jdsample's fancy (triangle) upsampling for
  2:1 horizontal, vertical and both (the row above and below across MCU
  rows, the edge sample repeated at the downsampled width and height; plain
  replication where libjpeg uses it: other integral ratios such as 4:1:1, and
  2:1 with a downsampled width of 2 or less), jdcolor's integer YCbCr->RGB
  tables (SCALEBITS 16) with range limiting, and a gray file repeated to
  three channels;
- orientation: cv2.imread applies the Exif orientation (1-8) with flips and
  a transpose; `jpeg_shape` reads the oriented (height, width) from the
  headers alone.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

SOI = b"\xff\xd8"

# the natural (row-major) index of each zigzag position
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNZIGZAG = np.argsort(ZIGZAG)                 # zigzag position of each natural index

_UNSUPPORTED_SOF = {0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
                    0xC6: "hierarchical progressive JPEG (SOF6)",
                    0xC7: "hierarchical lossless JPEG (SOF7)",
                    0xC9: "arithmetic-coded JPEG (SOF9)",
                    0xCA: "arithmetic-coded progressive JPEG (SOF10)",
                    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
                    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
                    0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
                    0xCF: "arithmetic-coded hierarchical JPEG (SOF15)"}


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "width", "height", "bx", "by", "offset")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None                      # latched at the component's first scan


class _Frame:
    """SOFn's fields plus what libjpeg derives from them (jdinput.c
    initial_setup): each component's downsampled size and its block array,
    padded to whole MCUs."""

    def __init__(self, marker: int, body: bytes, path: str):
        precision, self.height, self.width, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise NotImplementedError(f"{path}: {precision}-bit JPEG samples are not read by "
                                      "the port (8-bit only)")
        if n == 4:
            raise NotImplementedError(f"{path}: 4-component (CMYK/YCCK) JPEG is not read by "
                                      "the port")
        if n not in (1, 3):
            raise NotImplementedError(f"{path}: {n}-component JPEG is not read by the port")
        if self.height == 0:
            raise NotImplementedError(f"{path}: JPEG with its height in a DNL marker is not "
                                      "read by the port")
        self.progressive = marker == 0xC2
        self.comps = []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcu_cols = -(-self.width // (8 * self.hmax))
        self.mcu_rows = -(-self.height // (8 * self.vmax))
        offset = 0
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise NotImplementedError(f"{path}: JPEG sampling factors {c.h}x{c.v} under "
                                          f"{self.hmax}x{self.vmax} are not integral")
            c.width = -(-self.width * c.h // self.hmax)
            c.height = -(-self.height * c.v // self.vmax)
            c.bx, c.by = self.mcu_cols * c.h, self.mcu_rows * c.v
            c.offset = offset
            offset += c.bx * c.by * 64
        self.n_coefs = offset


# ---- Huffman tables ---------------------------------------------------------------

@functools.lru_cache(maxsize=16)         # a table's two lists take about 9 MB
def _tables(counts: bytes, symbols: bytes) -> Tuple[list, list]:
    """For one DHT table: (fast, codes), each a list over the 2^16 values of
    the next 16 bits of the scan. codes[w] = (code length, symbol), length 0
    where no code starts w. fast[w] = (bits used, zero run, value) for the
    symbol's run/size byte: value is the extended coefficient (or DC
    difference) when code and extra bits fit in 16 bits, else the entry is
    (0, 0, 0) and the caller takes the codes path; a symbol of size 0 (EOB,
    EOBn, ZRL, a DC difference of 0) gives (code length, run, 0)."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            if code >= 1 << n:
                raise ValueError("invalid JPEG Huffman table")
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi] = n
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    w = np.arange(1 << 16, dtype=np.int64)
    run, size = symbol >> 4, symbol & 15
    used = length + size
    fits = (length > 0) & (used <= 16)
    extra = (w >> np.maximum(16 - used, 0)) & ((1 << size) - 1)
    value = np.where(extra >> np.maximum(size - 1, 0) > 0, extra, extra - (1 << size) + 1)
    value = np.where(size > 0, value, 0)
    fast = list(zip(np.where(fits, used, 0).tolist(), np.where(fits, run, 0).tolist(),
                    np.where(fits, value, 0).tolist()))
    codes = list(zip(length.tolist(), symbol.tolist()))
    return fast, codes


def _slow(codes: list, win, p: int) -> Tuple[int, int, int]:
    """The fast-table triple for a symbol whose code and extra bits do not
    fit in 16 bits: the code from the symbol table, the extra bits from the
    window after it."""
    n, sym = codes[win[p]]
    if not n:
        raise ValueError("corrupt JPEG data: bad Huffman code")
    run, size = sym >> 4, sym & 15
    if not size:
        return n, run, 0
    bits = win[p + n] >> (16 - size)
    return n + size, run, (bits if bits >> (size - 1) else bits - (1 << size) + 1)


# ---- the scan ---------------------------------------------------------------------

_PAD = 64                                     # zero bytes after the scan's data


def _scan_bits(buf: np.ndarray, start: int):
    """The entropy-coded segment from `start`: (16-bit window at every bit
    offset as a memoryview, bit offsets at which restart segments 1, 2, ...
    begin, position of the marker that ends the scan)."""
    ff = np.flatnonzero(buf[start:-1] == 0xFF) + start
    nxt = buf[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    stop = np.flatnonzero((nxt != 0) & ~rst)
    end = int(ff[stop[0]]) if len(stop) else len(buf)
    inside = ff < end
    ff, nxt, rst = ff[inside], nxt[inside], rst[inside]
    keep = np.ones(end - start, bool)
    keep[ff[nxt == 0] + 1 - start] = False
    marks = ff[rst] - start
    keep[marks] = False
    keep[marks + 1] = False
    body = np.concatenate([buf[start:end][keep], np.zeros(_PAD, np.uint8)]).astype(np.uint32)
    restarts = (np.cumsum(keep)[marks + 1] * 8).tolist() if len(marks) else []
    w24 = (body[:-2] << 16) | (body[1:-1] << 8) | body[2:]
    shifts = np.arange(8, 0, -1, dtype=np.uint32)
    win = ((w24[:, None] >> shifts) & 0xFFFF).astype(np.uint16).reshape(-1)
    return memoryview(win), restarts, end


def _scan_blocks(frame: _Frame, comps: List[_Component]) -> Tuple[List[int], List[int], int]:
    """(coefficient-list offset of each block in decode order, its index in
    the scan's component list, blocks per MCU). Several components: whole
    MCUs, each component's h x v blocks in turn; one component: its blocks in
    raster order over its own size (jdinput.c per_scan_setup)."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = np.meshgrid(np.arange(-(-c.height // 8)), np.arange(-(-c.width // 8)),
                                 indexing="ij")
        base = c.offset + (rows.reshape(-1) * c.bx + cols.reshape(-1)) * 64
        return base.tolist(), [0] * base.size, 1
    my, mx = np.meshgrid(np.arange(frame.mcu_rows), np.arange(frame.mcu_cols), indexing="ij")
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    parts, slots = [], []
    for i, c in enumerate(comps):
        v, h = np.meshgrid(np.arange(c.v), np.arange(c.h), indexing="ij")
        v, h = v.reshape(1, -1), h.reshape(1, -1)
        parts.append(c.offset + ((my * c.v + v) * c.bx + mx * c.h + h) * 64)
        slots += [i] * (c.h * c.v)
    base = np.concatenate(parts, axis=1)
    return base.reshape(-1).tolist(), slots * (my.size), len(slots)


def _sequential(coef, win, bases, slots, tabs, every, restarts):
    """A baseline / extended-sequential scan: every block's DC difference and
    its AC run/size symbols, in place into `coef` (zigzag order)."""
    pred = [0] * len(tabs)
    p = 0
    seg = 0
    for n, base in enumerate(bases):
        if every and n and n % every == 0:
            p = restarts[seg]
            seg += 1
            pred = [0] * len(tabs)
        ci = slots[n]
        (dc, dcc), (ac, acc) = tabs[ci]
        l, _, v = dc[win[p]]
        if not l:
            l, _, v = _slow(dcc, win, p)
        p += l
        v += pred[ci]
        pred[ci] = v
        coef[base] = v
        k = 1
        while k < 64:
            l, r, v = ac[win[p]]
            if not l:
                l, r, v = _slow(acc, win, p)
            p += l
            if v:
                k += r
                coef[base + k] = v
                k += 1
            elif r == 15:
                k += 16
            else:
                break


def _dc_first(coef, win, bases, slots, tabs, every, restarts, al):
    """A progressive scan's first pass over the DC coefficients: each block's
    difference, scaled up by `al` bits."""
    pred = [0] * len(tabs)
    p = 0
    seg = 0
    for n, base in enumerate(bases):
        if every and n and n % every == 0:
            p = restarts[seg]
            seg += 1
            pred = [0] * len(tabs)
        ci = slots[n]
        dc, dcc = tabs[ci][0]
        l, _, v = dc[win[p]]
        if not l:
            l, _, v = _slow(dcc, win, p)
        p += l
        v += pred[ci]
        pred[ci] = v
        coef[base] = v << al


def _dc_refine(coef, win, bases, every, restarts, al):
    """A later DC pass: one raw bit a block, bit `al` of its DC coefficient."""
    p = 0
    seg = 0
    bit = 1 << al
    for n, base in enumerate(bases):
        if every and n and n % every == 0:
            p = restarts[seg]
            seg += 1
        if win[p] >> 15:
            coef[base] |= bit
        p += 1


def _ac_first(coef, win, bases, tab, every, restarts, ss, se, al):
    """A progressive scan's first pass over the band ss..se of one component:
    run/size symbols as in a sequential scan, scaled up by `al` bits, and
    end-of-band runs that cover whole blocks."""
    ac, acc = tab
    eobrun = 0
    p = 0
    seg = 0
    for n, base in enumerate(bases):
        if every and n and n % every == 0:
            p = restarts[seg]
            seg += 1
            eobrun = 0
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            l, r, v = ac[win[p]]
            if not l:
                l, r, v = _slow(acc, win, p)
            p += l
            if v:
                k += r
                coef[base + k] = v << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = (1 << r) - 1
                if r:
                    eobrun += win[p] >> (16 - r)
                    p += r
                break


def _ac_refine(coef, win, bases, tab, every, restarts, ss, se, al):
    """jdphuff.c decode_mcu_AC_refine: new coefficients of magnitude 1 << al,
    and a correction bit for each coefficient already nonzero that the zero
    run or the end-of-band run passes over."""
    ac, acc = tab
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    p = 0
    seg = 0
    for n, base in enumerate(bases):
        if every and n and n % every == 0:
            p = restarts[seg]
            seg += 1
            eobrun = 0
        k = ss
        if not eobrun:
            while k <= se:
                l, r, v = ac[win[p]]
                if not l:
                    l, r, v = _slow(acc, win, p)
                p += l
                if v:
                    s = p1 if v > 0 else m1
                elif r == 15:
                    s = 0
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[p] >> (16 - r)
                        p += r
                    break
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if win[p] >> 15 and not c & p1:
                            coef[base + k] = c + p1 if c >= 0 else c + m1
                        p += 1
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if s:
                    coef[base + min(k, 63)] = s
                k += 1
        if eobrun:
            while k <= se:
                c = coef[base + k]
                if c:
                    if win[p] >> 15 and not c & p1:
                        coef[base + k] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1


# ---- markers ----------------------------------------------------------------------

def _marker(data: bytes, pos: int, path: str) -> Tuple[int, int, int]:
    """The marker at or after `pos` (fill bytes and stray data skipped, as
    libjpeg's next_marker does): (marker, start of its body, end of its
    segment); markers without a body (SOI, EOI, RSTn, TEM) end where they
    start."""
    n = len(data)
    while pos < n and data[pos] != 0xFF:
        pos += 1
    while pos < n and data[pos] == 0xFF:
        pos += 1
    if pos >= n:
        raise ValueError(f"{path}: JPEG data ends before EOI")
    marker = data[pos]
    pos += 1
    if marker == 0x01 or 0xD0 <= marker <= 0xD9:
        return marker, pos, pos
    if pos + 2 > n:
        raise ValueError(f"{path}: JPEG data ends inside a marker")
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    return marker, pos + 2, pos + length


def _orientation(app1: Optional[bytes]) -> int:
    """The Exif orientation tag (0x0112) of IFD0 in the first APP1 segment,
    which cv2 parses from its seventh byte on as a TIFF header; 1 without one."""
    if app1 is None or len(app1) < 14:
        return 1
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            if struct.unpack(order + "H", entry[:2])[0] == 0x0112:
                return struct.unpack(order + "H", entry[8:10])[0]
    except struct.error:
        pass
    return 1


def _unsupported(marker: int, path: str):
    if marker in _UNSUPPORTED_SOF:
        raise NotImplementedError(f"{path}: {_UNSUPPORTED_SOF[marker]} is not read by the port "
                                  "(baseline, extended and progressive Huffman only)")
    if marker == 0xCC:
        raise NotImplementedError(f"{path}: arithmetic-coded JPEG (DAC marker) is not read by "
                                  "the port")


def _header(data: bytes, path: str) -> Tuple[_Frame, int]:
    """The frame header and the Exif orientation, from the markers before the
    first scan."""
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    app1, frame = None, None
    pos = 2
    while True:
        marker, body, pos = _marker(data, pos, path)
        _unsupported(marker, path)
        if marker == 0xE1 and app1 is None:
            app1 = data[body:pos]
        elif marker in (0xC0, 0xC1, 0xC2):
            frame = _Frame(marker, data[body:pos], path)
        elif marker in (0xDA, 0xD9):
            break
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    return frame, _orientation(app1)


def jpeg_shape(data: bytes, path: str = "<bytes>") -> Tuple[int, int]:
    """(height, width) of a JPEG file as cv2.imread returns it: after the
    Exif orientation, from the headers alone."""
    frame, orientation = _header(data, path)
    if orientation in (5, 6, 7, 8):
        return frame.width, frame.height
    return frame.height, frame.width


def _scan(data, buf, pos, body, frame, qts, huff, every, coef, path):
    """Decode the scan whose SOS header is data[body:pos] into `coef`; the
    position of the marker after its data."""
    ns = data[body]
    by_id = {c.cid: c for c in frame.comps}
    comps, tabs = [], []
    for i in range(ns):
        cid, t = data[body + 1 + 2 * i], data[body + 2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{path}: JPEG scan names an unknown component {cid}")
        c = by_id[cid]
        if c.qt is None:
            if c.tq not in qts:
                raise ValueError(f"{path}: JPEG quantisation table {c.tq} is missing")
            c.qt = qts[c.tq]
        comps.append(c)
        tabs.append((huff.get((0, t >> 4)), huff.get((1, t & 15))))
    ss, se, a = data[body + 1 + 2 * ns:body + 4 + 2 * ns]
    ah, al = a >> 4, a & 15
    win, restarts, stop = _scan_bits(buf, pos)
    bases, slots, per_mcu = _scan_blocks(frame, comps)
    blocks = every * per_mcu
    if not frame.progressive:
        needed = [t for pair in tabs for t in pair]
    elif ss == 0:
        needed = [] if ah else [t[0] for t in tabs]
    else:
        needed = [tabs[0][1]]
    if any(t is None for t in needed):
        raise ValueError(f"{path}: JPEG scan uses a Huffman table that was not defined")
    try:
        if not frame.progressive:
            _sequential(coef, win, bases, slots, tabs, blocks, restarts)
        elif ss == 0:
            if ah:
                _dc_refine(coef, win, bases, blocks, restarts, al)
            else:
                _dc_first(coef, win, bases, slots, tabs, blocks, restarts, al)
        elif ah:
            _ac_refine(coef, win, bases, tabs[0][1], blocks, restarts, ss, se, al)
        else:
            _ac_first(coef, win, bases, tabs[0][1], blocks, restarts, ss, se, al)
    except IndexError:
        raise ValueError(f"{path}: JPEG scan data ends early") from None
    return stop


def _coefficients(data: bytes, path: str):
    """Parse every marker and decode every scan: (frame, coefficients as an
    (n_blocks, 64) int64 array in zigzag order over all components, Exif
    orientation, whether the 3 components are RGB rather than YCbCr)."""
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    qts: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[list, list]] = {}
    frame: Optional[_Frame] = None
    coef: List[int] = []
    app1, jfif, adobe = None, False, None
    every = 0
    pos = 2
    scans = 0
    while True:
        marker, body, pos = _marker(data, pos, path)
        _unsupported(marker, path)
        seg = data[body:pos]
        if marker == 0xD9:
            break
        if marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and app1 is None:
            app1 = seg
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    qts[tq] = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    qts[tq] = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                counts = bytes(seg[i + 1:i + 17])
                n = sum(counts)
                huff[(seg[i] >> 4, seg[i] & 15)] = _tables(counts, bytes(seg[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDD:
            (every,) = struct.unpack(">H", seg[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{path}: JPEG with two frame headers")
            frame = _Frame(marker, seg, path)
            coef = [0] * (frame.n_coefs + 128)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before the frame header")
            pos = _scan(data, buf, pos, body, frame, qts, huff, every, coef, path)
            scans += 1
            if pos >= len(data):
                break                       # no EOI: libjpeg ends the image there too
    if not scans:
        raise ValueError(f"{path}: JPEG without a scan")
    rgb = (len(frame.comps) == 3 and not jfif
           and (adobe == 0 or (adobe is None
                               and [c.cid for c in frame.comps] == [82, 71, 66])))  # 'R','G','B'
    return (frame, np.asarray(coef[:frame.n_coefs], np.int64).reshape(-1, 64),
            _orientation(app1), rgb)


# ---- samples ----------------------------------------------------------------------

# jdmaster.c prepare_range_limit_table, as the IDCT indexes it: sample + 128
# clamped to [0, 255] for |x| < 512, wrapping through the low 10 bits beyond
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)


def _idct_1d(c, shift: int):
    """One pass of jidctint.c's jpeg_idct_islow over axis -2 of `c` (8 x n):
    the 8 outputs, descaled by `shift` bits with rounding."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * 4433                              # FIX_0_541196100
    tmp2 = z1 - z3 * 15137                             # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                              # FIX_0_765366865
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                              # FIX_1_175875602
    t0 = t0 * 2446                                     # FIX_0_298631336
    t1 = t1 * 16819                                    # FIX_2_053119869
    t2 = t2 * 25172                                    # FIX_3_072711026
    t3 = t3 * 12299                                    # FIX_1_501321110
    z1 = z1 * -7373                                    # FIX_0_899976223
    z2 = z2 * -20995                                   # FIX_2_562915447
    z3 = z3 * -16069 + z5                              # FIX_1_961570560
    z4 = z4 * -3196 + z5                               # FIX_0_390180644
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return np.stack([(o + half) >> shift for o in out])


def _plane(coef: np.ndarray, c: _Component) -> np.ndarray:
    """A component's samples (height, width) uint8 from its zigzag
    coefficients: dequantise, IDCT every block, crop to the downsampled size."""
    blocks = coef[c.offset // 64:c.offset // 64 + c.bx * c.by]
    blocks = (blocks * c.qt)[:, _UNZIGZAG].reshape(-1, 8, 8)      # (n, v, u)
    ws = _idct_1d(blocks.transpose(1, 0, 2), 11)                  # columns: (y, n, u)
    px = _idct_1d(ws.transpose(2, 1, 0), 18)                      # rows: (x, n, y)
    px = _IDCT_LIMIT[px & 1023].transpose(1, 2, 0)                # (n, y, x)
    px = px.reshape(c.by, c.bx, 8, 8).transpose(0, 2, 1, 3).reshape(c.by * 8, c.bx * 8)
    return px[:c.height, :c.width]


def _edges(x: np.ndarray, axis: int):
    """x's neighbours before and after along `axis`, the edge repeated."""
    n = x.shape[axis]
    before = np.take(x, np.r_[0, :n - 1], axis=axis)
    after = np.take(x, np.r_[1:n, n - 1], axis=axis)
    return before, after


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(x: np.ndarray, hr: int, vr: int, frame: _Frame) -> np.ndarray:
    """jdsample.c's upsampler for a component at ratio hr x vr to the
    image's size: fancy triangle filters for 2x1, 1x2 and 2x2 (2x1 and 2x2
    only where the downsampled width exceeds 2), else replication."""
    x = x.astype(np.int32)
    w = x.shape[1]
    if (hr, vr) == (2, 1) and w > 2:
        left, right = _edges(x, 1)
        x = _interleave((3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2, 1)
    elif (hr, vr) == (1, 2):
        up, down = _edges(x, 0)
        x = _interleave((3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2, 0)
    elif (hr, vr) == (2, 2) and w > 2:
        up, down = _edges(x, 0)
        rows = _interleave(3 * x + up, 3 * x + down, 0)             # column sums
        left, right = _edges(rows, 1)
        x = _interleave((3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4, 1)
    elif hr > 1 or vr > 1:
        x = np.repeat(np.repeat(x, vr, axis=0), hr, axis=1)
    return x[:frame.height, :frame.width]


def _fix(v: float) -> int:
    return int(v * 65536 + 0.5)


_CB = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CB + 32768) >> 16
_CB_B = (_fix(1.77200) * _CB + 32768) >> 16
_CR_G = -_fix(0.71414) * _CB
_CB_G = -_fix(0.34414) * _CB + 32768


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: table lookups in 16-bit fixed point, each
    channel range-limited to [0, 255]."""
    g = (_CB_G[cb] + _CR_G[cr]) >> 16
    rgb = np.stack([y + _CR_R[cr], y + g, y + _CB_B[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform (loadsave.cpp): 2 mirror, 3 rotate 180, 4 flip,
    5 transpose, 6 transpose + mirror, 7 transpose + rotate 180, 8 transpose
    + flip; other values leave the image as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB: cv2.imdecode(data, IMREAD_COLOR) with its
    channels reversed, bit for bit."""
    frame, coef, orientation, rgb = _coefficients(data, path)
    planes = [_plane(coef, c) for c in frame.comps]
    planes = [_upsample(p, frame.hmax // c.h, frame.vmax // c.v, frame)
              for p, c in zip(planes, frame.comps)]
    if len(planes) == 1:
        img = np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    elif rgb:
        img = np.stack(planes, axis=-1).astype(np.uint8)
    else:
        img = _ycc_to_rgb(*planes)
    return _orient(img, orientation)
