"""Image files without PIL: PNG read and write, PIL's Lanczos resize, GIF.

The JAX package's loaders open and resize images with PIL; the port keeps
to numpy and the standard library, so this module does what they need:

  * ``decode_png`` / ``read_png``: 8-bit gray, gray + alpha, RGB and RGBA
    and palette images (1, 2, 4 or 8 bits an index, with ``tRNS``),
    non-interlaced, all five row filters; ``to_rgba`` is PIL's
    ``convert("RGBA")`` of what was read.  Anything else raises with the
    reason.
  * ``write_png``: 8-bit RGB or RGBA, filter 0 on every row.
  * ``read_rgb``: a PNG or a JPEG (``data/jpeg.py``), told apart by the
    file's first bytes as PIL tells them apart, as PIL's
    ``open(...).convert("RGB")``.
  * ``resize_lanczos``: ``PIL.Image.resize(size, Image.LANCZOS)`` on an
    8-bit image, reproduced step for step (``libImaging/Resample.c``): a
    horizontal then a vertical pass of a filter of support 3 x scale whose
    coefficients are normalised, then made fixed point with 22 fraction
    bits; each pass rounds and clips to uint8.  RGBA and LA images are
    premultiplied by alpha first and divided after, as PIL does.  A resize
    to the image's own size is a copy.
  * ``write_gif``: an animated GIF89a over a fixed 3-3-2 palette of 256
    colours (LZW coded here), for the eval video.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .jpeg import decode_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (mode, channels)
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                6: ("RGBA", 4)}


class PngImage(NamedTuple):
    """``pixels`` (H, W) for L and P, else (H, W, C) uint8; ``palette``
    (n, 3) uint8 for P; ``transparency``: per-index alphas for P, the
    colour key for L and RGB, else None."""
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None
    transparency: Optional[np.ndarray] = None


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray, unit: int) -> np.ndarray:
    """Undo the row filters.  raw (H, stride) uint8 without the filter
    bytes, ``unit`` bytes a filter step (a pixel, at least one byte)."""
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    H, stride = raw.shape
    P = stride // unit
    x = raw.reshape(H, P, unit).astype(np.int32)
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up only: each row at once
        out = np.empty_like(x)
        prev = np.zeros_like(x[0])
        for y in range(H):
            f = ftype[y]
            row = x[y]
            if f == 1:
                row = np.cumsum(row, axis=0)
            elif f == 2:
                row = row + prev
            out[y] = prev = row & 255
        return out.astype(np.uint8).reshape(H, stride)
    # Average / Paeth depend on the left, upper and upper-left bytes: run
    # the anti-diagonals of pixels in order, each at once, every row with
    # its own filter.  rec is padded by a zero row above and column left.
    rec = np.zeros((H + 1, P + 1, unit), np.int32)
    f_all = ftype.astype(np.int32)
    for d in range(H + P - 1):
        ys = np.arange(max(0, d - P + 1), min(H, d + 1))
        xs = d - ys
        a = rec[ys + 1, xs]
        b = rec[ys, xs + 1]
        c = rec[ys, xs]
        f = f_all[ys][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, xs + 1] = (x[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(H, stride)


def decode_png(data: bytes) -> PngImage:
    """Decode the bytes of a PNG file."""
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"PNG color type {ctype} is not a PNG color type")
    mode, channels = _COLOR_TYPES[ctype]
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt} "
                         f"unknown")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    if depth != 8 and not (mode == "P" and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit {mode} PNGs are not supported (8-bit "
                         f"images, and 1/2/4/8-bit palette images, are)")
    if mode == "P" and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    stride = (W * channels * depth + 7) // 8
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != H * (stride + 1):
        raise ValueError(f"PNG image data holds {buf.size} bytes, expected "
                         f"{H * (stride + 1)}")
    rows = buf.reshape(H, stride + 1)
    img = _unfilter(rows[:, 1:], rows[:, 0], max(1, channels * depth // 8))
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        img = ((img[:, :, None] >> shifts) & ((1 << depth) - 1)) \
            .reshape(H, -1)[:, :W]
    pixels = img.reshape(H, W) if channels == 1 else img.reshape(H, W,
                                                                 channels)
    transparency = None
    if trns is not None:
        if mode == "P":
            transparency = np.frombuffer(trns, np.uint8)
        elif mode in ("L", "RGB"):
            key = np.array(struct.unpack(f">{channels}H", trns[:2 * channels]))
            transparency = key.astype(np.int64)
    return PngImage(pixels, mode, palette, transparency)


def read_png(path: str) -> PngImage:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgba(img: PngImage) -> np.ndarray:
    """(H, W, 4) uint8: PIL's ``convert("RGBA")`` of the decoded image
    (gray spread to RGB; the palette looked up with its ``tRNS`` alphas;
    a gray or RGB colour key gives alpha 0)."""
    px = img.pixels
    if img.mode == "RGBA":
        return px.copy()
    if img.mode == "P":
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(img.palette), :3] = img.palette
        if img.transparency is not None:
            pal[:len(img.transparency), 3] = img.transparency
        return pal[px]
    H, W = px.shape[:2]
    out = np.empty((H, W, 4), np.uint8)
    if img.mode in ("L", "LA"):
        gray = px if img.mode == "L" else px[..., 0]
        out[..., :3] = gray[..., None]
        out[..., 3] = 255 if img.mode == "L" else px[..., 1]
    else:
        out[..., :3] = px
        out[..., 3] = 255
    if img.transparency is not None and img.mode in ("L", "RGB"):
        key = img.transparency
        same = (px == key[0]) if img.mode == "L" else (px == key).all(-1)
        out[same, 3] = 0
    return out


def read_rgba(path: str) -> np.ndarray:
    """A PNG file as (H, W, 4) uint8 RGBA (PIL's ``open(...).convert(
    "RGBA")``)."""
    return to_rgba(read_png(path))


def read_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG file as (H, W, 3) uint8 RGB (PIL's ``open(path)
    .convert("RGB")``), by its magic bytes, whatever its extension."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        return to_rgba(decode_png(data))[..., :3].copy()
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> PNG bytes, filter 0 on every row."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes (H, W, 3|4) uint8, got "
                         f"{img.shape} {img.dtype}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           img.reshape(H, W * C)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2 if C == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ----------------------------------------------------------------------
# PIL's Lanczos resize (libImaging/Resample.c, 8 bits a channel)
# ----------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), fixed-point weights (out, ksize)),
    weights zero past each output's last input."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            kk[xx, x] = int((-0.5 if w < 0 else 0.5)
                            + w * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along ``axis`` (1: width, 0: height)."""
    in_size = img.shape[axis]
    first, kk = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    wshape = (out_size,) + (1,) * (src.ndim - 1)
    for j in range(kk.shape[1]):
        idx = np.minimum(first + j, in_size - 1)
        acc += src[idx] * kk[:, j].reshape(wshape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (PIL's rgbA2rgba: MULDIV255 with rounding)."""
    a = img[..., -1:].astype(np.int64)
    t = img[..., :-1].astype(np.int64) * a + 128
    return np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8),
                           img[..., -1:]], -1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (PIL's rgba2rgbA: 255 v / a, truncated and clipped;
    alpha 0 and 255 keep v)."""
    a = img[..., -1:].astype(np.int64)
    v = img[..., :-1].astype(np.int64)
    div = np.clip((255 * v) // np.maximum(a, 1), 0, 255)
    keep = (a == 0) | (a == 255)
    return np.concatenate([np.where(keep, v, div).astype(np.uint8),
                           img[..., -1:]], -1)


def resize_lanczos(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize(size, Image.LANCZOS)`` as an
    array.  img (H, W) or (H, W, C) uint8, C = 2 (LA) or 4 (RGBA)
    premultiplied around the passes; size (W, H)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8, got {img.dtype}")
    W, H = (int(s) for s in size)
    if (img.shape[1], img.shape[0]) == (W, H):
        return img.copy()
    alpha = img.ndim == 3 and img.shape[2] in (2, 4)
    out = _premultiply(img) if alpha else img
    if W != img.shape[1]:
        out = _pass(out, W, 1)
    if H != img.shape[0]:
        out = _pass(out, H, 0)
    return _unpremultiply(out) if alpha else out


# ----------------------------------------------------------------------
# GIF89a
# ----------------------------------------------------------------------

def gif_palette() -> np.ndarray:
    """The fixed 256-colour palette, (256, 3) uint8: index = r3 g3 b2."""
    i = np.arange(256)
    r, g, b = i >> 5, (i >> 2) & 7, i & 3
    return np.stack([r * 255 // 7, g * 255 // 7, b * 255 // 3],
                    1).astype(np.uint8)


def gif_indices(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices, each channel rounded to
    its nearest level."""
    img = img.astype(np.int64)
    r = (img[..., 0] * 7 + 127) // 255
    g = (img[..., 1] * 7 + 127) // 255
    b = (img[..., 2] * 3 + 127) // 255
    return ((r << 5) | (g << 2) | b).astype(np.uint8)


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's LZW: variable-width codes from min_size + 1 to 12 bits, LSB
    first, a clear code when the table is full.  A table entry is keyed by
    its prefix's code and its last symbol."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    size = min_size + 1
    emit(clear, size)
    table, nxt = {}, eoi + 1
    w = -1
    for ch in indices:
        if w < 0:
            w = ch
            continue
        key = (w << 8) | ch
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, size)
        table[key] = nxt
        nxt += 1
        if nxt - 1 == (1 << size) and size < 12:
            size += 1
        if nxt == 4096:
            emit(clear, size)
            table, nxt, size = {}, eoi + 1, min_size + 1
        w = ch
    if w >= 0:
        emit(w, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def encode_gif(frames: List[np.ndarray], fps: float = 30.0) -> bytes:
    """Animated GIF89a of (H, W, 3) uint8 frames, looping forever."""
    if not frames:
        raise ValueError("no frames to write")
    H, W = frames[0].shape[:2]
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", W, H, 0xF7, 0, 0)   # global table of 256
    out += gif_palette().tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    delay = int(round(100 / fps))
    for frame in frames:
        if frame.shape[:2] != (H, W):
            raise ValueError("GIF frames differ in size")
        out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0)
        out += struct.pack("<BHHHHB", 0x2C, 0, 0, W, H, 0)
        data = _lzw(gif_indices(frame[..., :3]).tobytes())
        out += b"\x08"
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            out += bytes([len(block)]) + block
        out += b"\x00"
    out += b"\x3b"
    return bytes(out)


def write_gif(path: str, frames: List[np.ndarray], fps: float = 30.0) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, fps))
