"""Image files without cv2 or PIL: a PNG codec on ``zlib`` and numpy, the
size of a PNG or JPEG from its header, and RGB reads that pick the decoder
from the file's bytes.

The JAX package's readers decode with ``cv2.imread`` and read label PNGs
and image sizes with PIL (mask_rcnn_tpu/data/coco.py:165,
mask_rcnn_tpu/data/voc.py:30-61); the machine the port serves on may have
neither. PNG (8 bits a sample, not interlaced: gray, gray + alpha, RGB,
RGBA and palette) is decoded here. JPEG, and any other format, goes
through cv2 when it imports, else PIL, else raises ``ImportError``.
Missing or corrupt files raise ``IOError``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples a pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
# JPEG start-of-frame markers (baseline, progressive, lossless, arithmetic)
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
             0xCD, 0xCE, 0xCF}


def _png_chunks(data: bytes, path: str):
    """Yield (type, body) of each chunk after the signature, checking the
    CRCs, up to IEND."""
    pos = len(_PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise IOError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise IOError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise IOError(f"{path}: corrupt PNG chunk {kind!r} (CRC)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _unfilter(rows: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the PNG scanline filters. ``rows`` is (h, 1 + w * c): each
    row's filter type, then its filtered bytes. A byte's predictor reads
    the reconstructed bytes to its left (a), above (b) and above-left (c),
    so the image is rebuilt one anti-diagonal of pixels at a time, all
    rows of the diagonal at once."""
    ftype = rows[:, 0].astype(np.int32)
    data = rows[:, 1:].reshape(h, w, c).astype(np.int32)
    if (ftype > 4).any():
        raise IOError(f"unknown PNG filter type {int(ftype.max())}")
    if not ftype.any():
        return data.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, c), np.int32)  # a zero row and column
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, cc = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        ft = ftype[y][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _decode_png(data: bytes, path: str):
    """PNG bytes -> (pixels, color type, palette or None). Pixels are
    (H, W) for gray and palette (the indices), else (H, W, C)."""
    header, idat, palette = None, [], None
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise IOError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise IOError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{ctype}, interlace {interlace}); the reader takes 8-bit, "
            "non-interlaced gray, gray + alpha, RGB, RGBA and palette")
    c = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"{path}: corrupt PNG data: {e}") from e
    if len(raw) != h * (1 + w * c):
        raise IOError(f"{path}: PNG data holds {len(raw)} bytes, expected "
                      f"{h * (1 + w * c)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    try:
        pixels = _unfilter(rows, h, w, c)
    except IOError as e:
        raise IOError(f"{path}: {e}") from e
    if ctype == 3 and palette is None:
        raise IOError(f"{path}: palette PNG without PLTE")
    return (pixels[..., 0] if c == 1 else pixels), ctype, palette


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) uint8 for gray and palette images (a palette
    image gives its indices, as a VOC label PNG needs), (H, W, C) for gray
    + alpha, RGB and RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise IOError(f"{path} is not a PNG file")
    return _decode_png(data, path)[0]


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) gray or (H, W, C) image, C in 1-4 (gray, gray
    + alpha, RGB, RGBA), as an unfiltered PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1-4) images, "
                         f"got {img.shape}")
    h, w, c = img.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter type 0 on each row
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def _jpeg_size(f, path: str) -> Tuple[int, int]:
    """(H, W) from a JPEG's start-of-frame segment."""
    f.read(2)  # SOI
    while True:
        byte = f.read(1)
        if not byte:
            raise IOError(f"{path}: JPEG without a start-of-frame marker")
        if byte != b"\xff":
            continue
        marker = f.read(1)
        while marker == b"\xff":  # fill bytes
            marker = f.read(1)
        if not marker:
            raise IOError(f"{path}: truncated JPEG")
        m = marker[0]
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue  # standalone markers carry no length
        seg = f.read(2)
        if len(seg) != 2:
            raise IOError(f"{path}: truncated JPEG segment")
        length = struct.unpack(">H", seg)[0]
        if m in _JPEG_SOF:
            body = f.read(5)
            if len(body) != 5:
                raise IOError(f"{path}: truncated JPEG frame header")
            h, w = struct.unpack(">HH", body[1:5])
            return h, w
        f.seek(length - 2, 1)


def image_size(path: str) -> Tuple[int, int]:
    """(H, W) of a PNG or JPEG from its header, without decoding pixels
    (the sizes the JAX readers take from PIL, for the train loader's
    aspect grouping)."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head.startswith(_PNG_SIGNATURE):
            if len(head) < 24 or head[12:16] != b"IHDR":
                raise IOError(f"{path}: PNG without IHDR")
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head.startswith(b"\xff\xd8"):
            f.seek(0)
            return _jpeg_size(f, path)
    raise IOError(f"{path} is neither a PNG nor a JPEG file")


def jpeg_decoder() -> Optional[str]:
    """The library that decodes JPEG here: 'cv2', 'PIL' or None."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        import PIL.Image  # noqa: F401

        return "PIL"
    except ImportError:
        return None


def _read_rgb_library(path: str) -> np.ndarray:
    """Decode any other format (JPEG above all) to RGB with cv2 (the JAX
    readers' decoder), else PIL."""
    decoder = jpeg_decoder()
    if decoder == "cv2":
        import cv2

        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise IOError(f"failed to read {path}")
        return bgr[:, :, ::-1].copy()
    if decoder == "PIL":
        import PIL.Image

        try:
            with PIL.Image.open(path) as im:
                return np.asarray(im.convert("RGB")).copy()
        except OSError as e:
            raise IOError(f"failed to read {path}: {e}") from e
    raise ImportError(
        f"decoding {path} (not a PNG) needs cv2 or PIL, and neither is "
        "installed")


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.imread(path, IMREAD_COLOR)[..., ::-1]``
    gives: the decoder is picked from the file's bytes (PNG here, other
    formats through :func:`jpeg_decoder`'s library); gray is replicated,
    alpha dropped and a palette expanded."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        return _read_rgb_library(path)
    pixels, ctype, palette = _decode_png(data, path)
    if ctype == 3:
        if pixels.max(initial=0) >= len(palette):
            raise IOError(f"{path}: palette index out of range")
        return palette[pixels]
    if ctype in (0, 4):
        gray = pixels if ctype == 0 else pixels[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def write_jpeg(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as JPEG with cv2 (quality 95, as
    the JAX package's ``cv2.imwrite`` writes), else PIL at the same
    quality; raises ``ImportError`` without either."""
    decoder = jpeg_decoder()
    if decoder == "cv2":
        import cv2

        if not cv2.imwrite(path, np.ascontiguousarray(rgb[:, :, ::-1])):
            raise IOError(f"failed to write {path}")
    elif decoder == "PIL":
        import PIL.Image

        PIL.Image.fromarray(np.ascontiguousarray(rgb)).save(
            path, format="JPEG", quality=95)
    else:
        raise ImportError(
            f"writing {path} as JPEG needs cv2 or PIL, and neither is "
            "installed")
