"""Host-side image loading/decoding for the pipeline.

The reference reads images with OpenCV (`cv::imread` at
`PointCloudProcessor/src/PointCloudProcessor.cpp:716`,
`visual_camera_calibration.cpp:171`, masks at `:775`). Decoding stays on the
host here; the decoded arrays are shipped to device once per keyframe batch.

Decoders, in order: OpenCV, then Pillow, then — for PNG only — the 8-bit
PNG codec below, which needs nothing but the standard library's ``zlib``
and numpy. A JPEG with neither OpenCV nor Pillow installed is an error
that names both.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_slow(kind: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) filters, in place. Sequential along the
    row by definition (each byte depends on the reconstructed byte to its
    left), so this is a plain Python loop: correct, and slow on large
    images — encoders from OpenCV/Pillow use these filters, and with those
    libraries installed this path is not taken."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG -> (H, W) or (H, W, C) uint8,
    with the standard library's zlib and numpy only."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB/RGBA PNG decodes "
            f"without OpenCV or Pillow (bit depth {depth}, color type "
            f"{color}, interlace {interlace})"
        )
    ch = _PNG_CHANNELS[color]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(height, stride + 1)
    kinds, pix = rows[:, 0], rows[:, 1:].copy()
    if not kinds.any():  # every row unfiltered: the common fast path
        out = pix
    else:
        out = np.empty_like(pix)
        prior = np.zeros(stride, np.uint8)
        for y in range(height):
            line, kind = pix[y], int(kinds[y])
            if kind == 1:  # Sub: running sum per channel, mod 256
                line = np.cumsum(
                    line.reshape(width, ch), axis=0, dtype=np.uint8
                ).reshape(-1)
            elif kind == 2:  # Up
                line = line + prior
            elif kind in (3, 4):
                buf = bytearray(line.tobytes())
                _unfilter_slow(kind, buf, prior.tobytes(), ch)
                line = np.frombuffer(bytes(buf), np.uint8)
            elif kind != 0:
                raise ValueError(f"{path}: bad PNG filter type {kind}")
            out[y] = line
            prior = out[y]
    img = out.reshape(height, width, ch)
    return img[:, :, 0] if ch == 1 else img


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Encode (H, W) gray or (H, W, 3) RGB uint8 as PNG (filter 0 rows,
    zlib ``level``), with the standard library only."""
    img = np.ascontiguousarray(img, np.uint8)
    height, width = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(height, -1)
    raw = np.zeros((height, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def _no_decoder(path: str) -> ImportError:
    return ImportError(
        f"cannot decode {path!r}: neither OpenCV (cv2) nor Pillow (PIL) is "
        "installed; install one of them, or use PNG images (decoded with "
        "zlib and numpy alone)"
    )


def _imread(path: str, gray: bool = False) -> np.ndarray:
    """RGB (H, W, 3) uint8, or (H, W) when ``gray``."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img if gray else img[:, :, ::-1].copy()  # BGR -> RGB
    except ImportError:
        pass
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L" if gray else "RGB"))
    except ImportError:
        pass
    if not path.lower().endswith(".png"):
        raise _no_decoder(path)
    img = read_png(path)
    if img.ndim == 3:
        img = img[:, :, :3] if img.shape[2] >= 3 else img[:, :, 0]
    if gray:
        if img.ndim == 3:  # ITU-R BT.601 luma, as cv2 IMREAD_GRAYSCALE
            img = np.rint(img.astype(np.float32) @ np.asarray(
                [0.299, 0.587, 0.114], np.float32)).astype(np.uint8)
        return img
    return img if img.ndim == 3 else np.repeat(img[:, :, None], 3, axis=2)


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    return np.asarray(_imread(path), dtype=np.uint8)


def load_gray_normalized(path: str) -> np.ndarray:
    """(H, W) float32 in [0, 1] — the NID cost's image input.

    The reference intends a normalized grayscale image
    (`visual_camera_calibration.cpp:169-173` divides by 255; NB the reference
    passes a 3-channel mat into a single-channel accessor there — a latent
    indexing bug — while its GUI path `visual_lidar_data.cpp` converts to
    grayscale properly. We implement the intended grayscale semantics.)
    """
    rgb = load_rgb(path).astype(np.float32)
    # ITU-R BT.601 luma, matching cv2.cvtColor(..., COLOR_RGB2GRAY).
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return (gray / 255.0).astype(np.float32)


def load_mask(path: str) -> np.ndarray:
    """(H, W) int32 segmentation label image (grayscale PNG), or raises."""
    return np.asarray(_imread(path, gray=True), dtype=np.int32)
