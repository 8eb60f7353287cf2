"""Image decoding (io/images.py): the zlib + numpy PNG codec that keeps the
pipeline independent of OpenCV and Pillow, and the decoder fallbacks."""

import struct
import sys
import zlib

import numpy as np
import pytest

from pointcloudprocessor_tpu.io import images as img_io


def _encode_png(img: np.ndarray, filter_type: int) -> bytes:
    """Independent PNG encoder applying one filter type to every row
    (PNG spec section 9), for 8-bit gray / RGB / RGBA."""
    color = {1: 0, 3: 2, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int64)
    bpp = 1 if img.ndim == 2 else img.shape[2]
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if filter_type == 0:
            f = x
        elif filter_type == 1:
            f = x - a
        elif filter_type == 2:
            f = x - b
        elif filter_type == 3:
            f = x - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            f = x - pred
        out.append(filter_type)
        out += (f % 256).astype(np.uint8).tobytes()
        prior = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    w = img.shape[1]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def _test_image(channels, h=23, w=31, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(xx * 7 + yy * 3) % 256, (xx * xx + 5 * yy) % 256,
              rng.integers(0, 256, (h, w)), (xx * yy) % 256]
    img = np.stack(planes[:channels], -1).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_read_png_every_filter_type(tmp_path, filter_type):
    img = _test_image(3, seed=filter_type)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, filter_type))
    np.testing.assert_array_equal(img_io.read_png(str(path)), img)


@pytest.mark.parametrize("channels", [1, 4])
def test_read_png_gray_and_rgba(tmp_path, channels):
    img = _test_image(channels)
    path = tmp_path / "g.png"
    path.write_bytes(_encode_png(img, 4))
    np.testing.assert_array_equal(img_io.read_png(str(path)), img)


def test_write_png_roundtrip_and_rejects_16_bit(tmp_path):
    img = _test_image(3, h=40, w=57)
    path = str(tmp_path / "w.png")
    img_io.write_png(path, img)
    np.testing.assert_array_equal(img_io.read_png(path), img)
    gray = str(tmp_path / "w1.png")
    img_io.write_png(gray, img[..., 1])
    np.testing.assert_array_equal(img_io.read_png(gray), img[..., 1])
    # A 16-bit header is refused with a clear error, not misread.
    data = bytearray(open(path, "rb").read())
    data[24] = 16  # IHDR bit depth
    bad = tmp_path / "b16.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="8-bit"):
        img_io.read_png(str(bad))


def _hide_decoders(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_loaders_decode_png_without_cv2_or_pil(tmp_path, monkeypatch):
    _hide_decoders(monkeypatch)
    img = _test_image(3)
    path = str(tmp_path / "x.png")
    img_io.write_png(path, img)
    np.testing.assert_array_equal(img_io.load_rgb(path), img)
    gray = img_io.load_gray_normalized(path)
    want = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]) / 255.0
    np.testing.assert_allclose(gray, want, atol=1e-5)
    mask_path = str(tmp_path / "m.png")
    img_io.write_png(mask_path, img[..., 2])
    np.testing.assert_array_equal(img_io.load_mask(mask_path), img[..., 2].astype(np.int32))


def test_jpeg_without_decoders_names_both_libraries(tmp_path, monkeypatch):
    _hide_decoders(monkeypatch)
    path = tmp_path / "x.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="OpenCV.*Pillow"):
        img_io.load_rgb(str(path))
