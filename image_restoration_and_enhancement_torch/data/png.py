"""PNG read and write with ``zlib`` and ``struct``, and the image-file entry
points of the port's data and evaluation layers.

The card's machine has no image codec, so the port reads and writes its own
PNG files: 8-bit greyscale, grey + alpha, RGB, RGBA and palette images,
non-interlaced, with all five row filters (written unfiltered). Other
formats (``.jpg``, ``.bmp``, ``.webp``, 16-bit or interlaced PNG) go through
PIL, imported inside the function; where PIL is missing they raise an error
that names the format. Nothing falls back to PNG unseen.

``load_image(path, "RGB" | "L")`` returns what ``np.array(Image.open(path)
.convert(mode))`` returns; for a PNG it computes PIL's conversions itself
(``L`` is PIL's fixed-point ITU-R 601-2 luma, alpha is dropped).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


class UnsupportedImage(ValueError):
    """A PNG this codec does not read (16-bit, sub-byte or interlaced)."""


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        yield kind, data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the row filters: raw rows of 1 + w * bpp bytes -> [h, w * bpp] uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(source) -> np.ndarray:
    """A PNG file (path or bytes) -> uint8 [H, W] (grey) or [H, W, C] (C = 2
    grey + alpha, 3 RGB, 4 RGBA; a palette image comes back RGB or RGBA)."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    idat, palette, trns, header = [], None, None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise UnsupportedImage(f"PNG with bit depth {depth}, colour type {ctype} and "
                               f"interlace {interlace}")
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)
    if ctype == 3:
        rgb = palette[px[..., 0]]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns
        return np.concatenate([rgb, alpha[px[..., 0]][..., None]], axis=-1)
    return px[..., 0] if bpp == 1 else px


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, 1] (grey), [H, W, 2] (grey + alpha), [H, W, 3]
    (RGB) or [H, W, 4] (RGBA) -> an unfiltered, zlib-compressed PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def _pil(path: str, action: str, what: Optional[str] = None):
    try:
        from PIL import Image
    except ImportError as e:
        what = what or f"the {os.path.splitext(path)[1] or '(no extension)'} format"
        raise RuntimeError(f"cannot {action} {path}: {what} needs PIL, which is not "
                           "installed (the port reads and writes only 8-bit PNG itself)") from e
    return Image


def to_mode(px: np.ndarray, mode: str) -> np.ndarray:
    """A decoded image (grey, grey + alpha, RGB or RGBA) -> PIL's ``convert``
    to "RGB" or "L"."""
    if px.ndim == 2:
        px = px[..., None]
    color = px[..., :3] if px.shape[-1] >= 3 else np.repeat(px[..., :1], 3, axis=-1)
    if mode == "RGB":
        return np.ascontiguousarray(color)
    if mode == "L":
        if px.shape[-1] < 3:
            return np.ascontiguousarray(px[..., 0])
        c = color.astype(np.uint32)
        return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    raise ValueError(f"mode {mode!r}: use 'RGB' or 'L'")


def load_image(path: str, mode: str = "RGB") -> np.ndarray:
    """``np.array(Image.open(path).convert(mode))`` for mode "RGB" or "L"."""
    what = None
    if _is_png(path):
        try:
            return to_mode(read_png(path), mode)
        except UnsupportedImage as e:   # 16-bit, sub-byte or interlaced: PIL's, below
            what = f"a {e}"
    with _pil(path, "read", what).open(path) as im:
        return np.array(im.convert(mode))


def save_image(path: str, img: np.ndarray, quality: Optional[int] = None) -> None:
    """Write uint8 HW or HWC ``img`` in the format its extension names: PNG
    with this codec, anything else through PIL (JPEG at PIL's default quality
    75 unless ``quality`` is given)."""
    if _is_png(path):
        write_png(path, img)
        return
    kwargs = {} if quality is None else {"quality": quality}
    _pil(path, "write").fromarray(np.asarray(img, np.uint8)).save(path, **kwargs)
