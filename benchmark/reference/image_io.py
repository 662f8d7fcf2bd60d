"""Image loading as linear floats: a frozen copy of the loading half of the
port's ``scene/image_io.py`` (a copy of ``radish_pt_tpu/scene/image_io.py``).

Replaces the reference's stb-based ``Image`` class
(``reference/src/image.cpp:14-90``): LDR images are loaded with gamma
1.0 (raw values as linear, matching ``stbi_ldr_to_hdr_gamma(1.f)`` at
scene.cpp:109), HDR via imageio.  Device-side bilinear sampling lives in
:mod:`radish_pt_tpu.scene.device_scene`.
"""

from __future__ import annotations

import os

import numpy as np


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr, RGBE) — own reader/writer; the reference relies on stb
# for this and imageio's plugin chain is unreliable for float decoding.
# ---------------------------------------------------------------------------


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.exp2(e - 136.0), 0.0)  # 2^(e-128) / 256
    return rgbe[..., :3] * scale[..., None]


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE file (flat or RLE scanlines) to float32 [H,W,3]."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at empty line, then resolution line
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    img = np.empty((h, w, 4), np.uint8)
    p = 0
    for row in range(h):
        if (
            w >= 8
            and w < 32768
            and p + 4 <= len(buf)
            and buf[p] == 2
            and buf[p + 1] == 2
            and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w
        ):
            # new-style RLE: 4 channel planes
            p += 4
            for ch in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:  # run
                        img[row, x : x + count - 128, ch] = buf[p]
                        x += count - 128
                        p += 1
                    else:  # literal
                        img[row, x : x + count, ch] = buf[p : p + count]
                        x += count
                        p += count
        else:
            flat = buf[p : p + w * 4].reshape(w, 4)
            img[row] = flat
            p += w * 4
    return _rgbe_to_float(img)


def load_image(path: str, flip_vertical: bool = True) -> np.ndarray:
    """Load an image as linear float32 RGB [H, W, 3].

    LDR formats are divided by 255 with NO gamma decode (gamma 1.0, like the
    reference).  ``flip_vertical`` mirrors ``stbi_set_flip_vertically_on_load``
    (on for textures, off for env maps — scene.cpp:110,134-136).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        img = read_hdr(path)
    elif ext == ".exr":
        import imageio.v3 as iio

        img = np.asarray(iio.imread(path), dtype=np.float32)
    else:
        from PIL import Image as PILImage

        with PILImage.open(path) as im:
            img = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] > 3:
        img = img[..., :3]
    if flip_vertical:
        img = img[::-1]
    return np.ascontiguousarray(img, dtype=np.float32)
