"""Host time to decode scene images with the port's own readers
(data/image_io.py), on frames of the synthetic driving scene:

- a 540x960 JPEG frame (Tanks' Ballroom size), 4:2:0 at quality 95 as
  tools/jpeg_writer.py writes it: the first decode (the Huffman tables'
  lookup lists built) and the best of three after it;
- a 375x1242 PNG frame (V-KITTI's size) with every row Paeth-filtered, as
  write_png(filter_type=4) writes it: the rows cv2's adaptive writer picks
  most, decoded by the anti-diagonal wavefront; and with Up rows, as the
  port writes its own files, decoded row by row;
- with --large, a 3024x4032 JPEG frame (an LLFF original), the 540x960
  frame tiled to that size.

    python -m nope_nerf_torch.tools.decode_timing [--large]

prints one JSON line of milliseconds. chip_smoke.py's phase 7 prints the
same numbers on the card's host.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from ..data.image_io import read_png, read_rgb8, write_png
from .jpeg_writer import write_jpeg


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def decode_times(jpeg_frame: np.ndarray, png_frame: np.ndarray, workdir: str,
                 large: Optional[tuple] = None) -> Dict[str, float]:
    """Decode times in ms of `jpeg_frame` written as a 4:2:0 q95 JPEG and of
    `png_frame` written with Paeth and with Up rows, under `workdir`; with
    `large` = (h, w), also of `jpeg_frame` tiled to that size."""
    out = {}
    path = os.path.join(workdir, "frame.jpg")
    write_jpeg(path, jpeg_frame, quality=95, sampling="4:2:0")
    h, w = jpeg_frame.shape[:2]
    out[f"jpeg_{h}x{w}_first_ms"] = _ms(lambda: read_rgb8(path))
    out[f"jpeg_{h}x{w}_ms"] = min(_ms(lambda: read_rgb8(path)) for _ in range(3))
    h, w = png_frame.shape[:2]
    for filt, label in ((4, "paeth"), (2, "up")):
        path = os.path.join(workdir, f"{label}.png")
        write_png(path, png_frame, filter_type=filt)
        out[f"png_{label}_{h}x{w}_ms"] = min(_ms(lambda: read_png(path)) for _ in range(3))
    if large:
        reps = (-(-large[0] // jpeg_frame.shape[0]), -(-large[1] // jpeg_frame.shape[1]), 1)
        big = np.tile(jpeg_frame, reps)[:large[0], :large[1]]
        path = os.path.join(workdir, "large.jpg")
        write_jpeg(path, np.ascontiguousarray(big), quality=95, sampling="4:2:0")
        out[f"jpeg_{large[0]}x{large[1]}_ms"] = _ms(lambda: read_rgb8(path))
    return out


def main(argv=None) -> None:
    from ..data import make_driving_scene
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--large", action="store_true", help="also a 3024x4032 JPEG frame")
    a = ap.parse_args(argv)

    def frame(h, w):
        img = make_driving_scene(n_frames=1, h=h, w=w, seed=0)["imgs"][0]
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    with tempfile.TemporaryDirectory() as tmp:
        times = decode_times(frame(540, 960), frame(375, 1242), tmp,
                             large=(3024, 4032) if a.large else None)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
