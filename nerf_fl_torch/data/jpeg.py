"""JPEG files without PIL: a decoder that returns what PIL returns, and a
baseline encoder.

  * ``decode_jpeg`` / ``read_jpeg``: baseline, extended-sequential and
    progressive Huffman JPEGs (SOF0 / SOF1 / SOF2: spectral selection,
    successive approximation and end-of-band runs as ``jdphuff.c`` reads
    them), 8-bit, 1 or 3 components with sampling
    factors up to 2 x 2 (4:4:4, 4:2:2, 4:4:0, 4:2:0), restart intervals,
    several scans; APPn and COM segments are skipped.  The result is
    PIL's ``Image.open(p).convert("RGB")``, which is libjpeg-turbo's
    default decode, reproduced step for step:
      - the Huffman decode runs on a lookahead table of the next 16 bits,
        which gives a code's symbol and its magnitude bits in one lookup
        (``_tables``); only a code whose length and magnitude bits pass 16
        takes a second read;
      - the ``islow`` integer IDCT (``jidctint.c``: 13 constant bits, 2
        bits kept between passes, the post-IDCT range-limit table), on
        every block at once;
      - "fancy" chroma upsampling (``jdsample.c``: h2v1 / h1v2 / h2v2
        triangle filters with their alternating rounding biases, the edge
        samples replicated past the component's own width and height;
        box replication where libjpeg-turbo uses it: a component at most
        2 samples wide, or other integral ratios);
      - the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 bits);
      - grayscale replicated to three channels, an Adobe transform 0 or
        'R', 'G', 'B' component ids read as RGB (libjpeg's colour-space
        guess).
    Lossless, hierarchical and arithmetic-coded files, 12-bit samples and
    CMYK raise, naming the file and the marker.
  * ``encode_jpeg`` / ``write_jpeg``: a baseline encoder for RGB images
    at PIL's defaults: libjpeg's fixed-point RGB -> YCbCr, 4:2:0 with
    libjpeg's 2 x 2 averaging and edge replication to whole MCUs, a float
    DCT, the IJG tables at quality 75 scaled as ``jpeg_quality_scaling``
    scales them, the standard Huffman tables of the JPEG standard's Annex
    K and a JFIF header.  It is vectorised over all blocks.  It need not
    give PIL's bytes; PIL reads what it writes as this module does.
"""
from __future__ import annotations

import functools
import math
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np


def _zigzag() -> np.ndarray:
    """ZIGZAG[k] = the natural (row-major) index of zigzag position k."""
    order = []
    for s in range(15):
        rows = range(max(0, s - 7), min(s, 7) + 1)
        rows = rows if s % 2 else reversed(rows)
        order += [r * 8 + (s - r) for r in rows]
    return np.array(order, np.int64)


ZIGZAG = _zigzag()

_SOF_NAMES = {
    0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)"}


class JpegError(ValueError):
    pass


class _Component(NamedTuple):
    cid: int
    h: int
    v: int
    tq: int


# ----------------------------------------------------------------------
# Huffman lookahead tables
# ----------------------------------------------------------------------

def _canonical(bits: bytes, vals: bytes):
    """(code lengths (n,), codes (n,), symbols (n,)) of a DHT table."""
    lengths, codes = [], []
    code = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lengths.append(length)
            codes.append(code)
            code += 1
        code <<= 1
    n = len(lengths)
    if n != len(vals) or n == 0:
        raise JpegError("a Huffman table's counts do not match its symbols")
    return (np.array(lengths, np.int64), np.array(codes, np.int64),
            np.frombuffer(vals, np.uint8).astype(np.int64))


def _lookup16(bits: bytes, vals: bytes):
    """For every 16-bit window: (code length, symbol), length 0 where no
    code is a prefix of the window."""
    lengths, codes, syms = _canonical(bits, vals)
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    for l, c, s in zip(lengths.tolist(), codes.tolist(), syms.tolist()):
        lo = c << (16 - l)
        length[lo:lo + (1 << (16 - l))] = l
        sym[lo:lo + (1 << (16 - l))] = s
    return length, sym


def _extend(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG's EXTEND: s magnitude bits -> the signed value."""
    return np.where((s > 0) & (v < (1 << np.maximum(s - 1, 0))),
                    v - (1 << s) + 1, v)


@functools.lru_cache(maxsize=32)
def _tables(bits: bytes, vals: bytes, ac: bool) -> List[Tuple[int, int, int]]:
    """The 65,536-entry lookahead table of one Huffman table: for a window
    whose code and magnitude bits fit in 16 bits, (bits consumed, run,
    value) (AC: run 64 is EOB, ZRL is run 15 and value 0; DC: run 0 and
    the DC difference); where they do not, (-code length, run, magnitude
    size), read in two steps; where no code matches, (0, 0, 0)."""
    length, sym = _lookup16(bits, vals)
    run = (sym >> 4) if ac else np.zeros_like(sym)
    size = (sym & 15) if ac else sym
    if not ac and size.max(initial=0) > 11:
        raise JpegError("a DC Huffman symbol above 11")
    win = np.arange(1 << 16, dtype=np.int64)
    total = length + size
    fits = (length > 0) & (total <= 16)
    shift = np.where(fits, 16 - total, 0)
    mag = (win >> shift) & ((1 << size) - 1)
    value = np.where(fits, _extend(mag, size), 0)
    if ac:
        eob = (sym == 0) & (length > 0)
        run = np.where(eob, 64, run)
    n = np.where(fits, total, -length)
    third = np.where(fits, value, size)
    return list(zip(n.tolist(), run.tolist(), third.tolist()))


@functools.lru_cache(maxsize=32)
def _symbols(bits: bytes, vals: bytes) -> List[Tuple[int, int]]:
    """(code length, symbol) for every 16-bit window (length 0: no code):
    the progressive scans' table, whose symbols mean more than a run and a
    size."""
    length, sym = _lookup16(bits, vals)
    return list(zip(length.tolist(), sym.tolist()))


# ----------------------------------------------------------------------
# the decoder
# ----------------------------------------------------------------------

def _segments(data: bytes, p: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``p``: its restart intervals, each with
    the stuffed zero bytes removed, and the offset of the marker that ends
    it."""
    arr = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(arr[p:-1] == 0xFF) + p
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0) & ~rst]
    end = int(ends[0]) if len(ends) else len(data)
    cuts = ff[rst & (ff < end)].tolist()
    out, start = [], p
    for c in cuts + [end]:
        out.append(data[start:c].replace(b"\xff\x00", b"\xff"))
        start = c + 2
    return out, end


def _windows(seg: bytes) -> List[int]:
    """w[i] = bytes i, i + 1, i + 2 as one 24-bit integer (zero past the
    end, as libjpeg reads a short segment)."""
    a = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.int64)
    return ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()


def _decode_scan(segs: List[bytes], order: List[Tuple[int, int]],
                 per_interval: int, tabs, coefs: List[list],
                 name: str) -> None:
    """Huffman-decode one sequential scan into the components' zigzag
    coefficient lists.  ``order`` is (scan component, flat base offset)
    for each block in decode order; ``per_interval`` blocks per restart
    interval; ``tabs`` is (dc table, ac table, coefficient list) for each
    scan component."""
    total = len(order)
    n_int = -(-total // per_interval)
    if len(segs) < n_int:
        raise JpegError(f"{name}: {len(segs)} restart intervals, expected "
                        f"{n_int}")
    for i in range(n_int):
        w = _windows(segs[i])
        limit = 8 * len(segs[i]) + 64
        pos = 0
        preds = [0] * len(tabs)
        for j, base in order[i * per_interval:(i + 1) * per_interval]:
            dct, act, flat = tabs[j]
            n, _, d = dct[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
            if n <= 0:
                if n == 0:
                    raise JpegError(f"{name}: corrupt DC code")
                pos -= n
                s = d
                off = pos & 7
                v = (w[pos >> 3] >> (24 - off - s)) & ((1 << s) - 1) \
                    if s else 0
                pos += s
                d = v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v
            else:
                pos += n
            preds[j] += d
            flat[base] = preds[j]
            k = 1
            while k < 64:
                n, r, v = act[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                if n <= 0:
                    if n == 0:
                        raise JpegError(f"{name}: corrupt AC code")
                    pos -= n
                    s = v
                    off = pos & 7
                    v = (w[pos >> 3] >> (24 - off - s)) & ((1 << s) - 1)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                else:
                    pos += n
                    if r == 64:
                        break
                k += r
                if k > 63:
                    raise JpegError(f"{name}: AC run past the block")
                flat[base + k] = v
                k += 1
            if pos > limit:
                raise JpegError(f"{name}: entropy data ends early")


def _decode_progressive(segs: List[bytes], order: List[Tuple[int, int]],
                        per_interval: int, tabs, name: str, ss: int, se: int,
                        ah: int, al: int) -> None:
    """Huffman-decode one progressive scan (``jdphuff.c``): a DC first or
    refining scan over ``order``'s blocks, or an AC first or refining scan
    of band ``ss``..``se`` of one component, with its end-of-band runs;
    ``tabs`` is (DC symbols, AC symbols, coefficient list) per scan
    component, the coefficients in zigzag order."""
    total = len(order)
    n_int = -(-total // per_interval)
    if len(segs) < n_int:
        raise JpegError(f"{name}: {len(segs)} restart intervals, expected "
                        f"{n_int}")
    p1, m1 = 1 << al, -(1 << al)
    for i in range(n_int):
        w = _windows(segs[i])
        limit = 8 * len(segs[i]) + 64
        pos = 0
        preds = [0] * len(tabs)
        eobrun = 0
        for j, base in order[i * per_interval:(i + 1) * per_interval]:
            dct, act, flat = tabs[j]
            if pos > limit:
                raise JpegError(f"{name}: entropy data ends early")
            if ss == 0:
                if ah:                                   # DC refinement
                    if (w[pos >> 3] >> (23 - (pos & 7))) & 1:
                        flat[base] |= p1
                    pos += 1
                    continue
                n, s = dct[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                if n == 0:
                    raise JpegError(f"{name}: corrupt DC code")
                pos += n
                d = 0
                if s:
                    d = (w[pos >> 3] >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if d < (1 << (s - 1)):
                        d -= (1 << s) - 1
                preds[j] += d
                flat[base] = preds[j] << al
                continue
            if ah == 0:                                  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    n, sym = act[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                    if n == 0:
                        raise JpegError(f"{name}: corrupt AC code")
                    pos += n
                    r, s = sym >> 4, sym & 15
                    if s:
                        k += r
                        v = (w[pos >> 3] >> (24 - (pos & 7) - s)) \
                            & ((1 << s) - 1)
                        pos += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        if k > se:
                            raise JpegError(f"{name}: AC run past the band")
                        flat[base + k] = v << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[pos >> 3] >> (24 - (pos & 7) - r)) \
                                & ((1 << r) - 1)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
                continue
            # AC refinement: a new coefficient of magnitude 1 << al at the
            # run's end; a correction bit for every non-zero one passed
            k = ss
            if eobrun == 0:
                while k <= se:
                    n, sym = act[(w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                    if n == 0:
                        raise JpegError(f"{name}: corrupt AC code")
                    pos += n
                    r, s = sym >> 4, sym & 15
                    if s:
                        s = p1 if (w[pos >> 3] >> (23 - (pos & 7))) & 1 \
                            else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[pos >> 3] >> (24 - (pos & 7) - r)) \
                                & ((1 << r) - 1)
                            pos += r
                        break
                    while k <= se:
                        c = flat[base + k]
                        if c:
                            if (w[pos >> 3] >> (23 - (pos & 7))) & 1 \
                                    and not c & p1:
                                flat[base + k] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > se:
                            raise JpegError(f"{name}: AC run past the band")
                        flat[base + k] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    c = flat[base + k]
                    if c:
                        if (w[pos >> 3] >> (23 - (pos & 7))) & 1 \
                                and not c & p1:
                            flat[base + k] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    k += 1
                eobrun -= 1


_C = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
          c1175=9633, c1501=12299, c1847=15137, c1961=16069, c2053=16819,
          c2562=20995, c3072=25172)


def _idct_1d(x, descale: int):
    """jidctint.c's butterfly on 8 int64 arrays; each output DESCALEd by
    ``descale`` bits (round half up, arithmetic shift)."""
    c = _C
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * c["c0541"]
    tmp2 = z1 + z3 * -c["c1847"]
    tmp3 = z1 + z2 * c["c0765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["c1175"]
    t0 = t0 * c["c0298"]
    t1 = t1 * c["c2053"]
    t2 = t2 * c["c3072"]
    t3 = t3 * c["c1501"]
    z1 = z1 * -c["c0899"]
    z2 = z2 * -c["c2562"]
    z3 = z3 * -c["c1961"] + z5
    z4 = z4 * -c["c0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (descale - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return [(o + half) >> descale for o in out]


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by (value & 1023): value + 128
    clamped to [0, 255] for values in [-512, 511], wrapping beyond."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE = _range_limit()


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(n, 64) natural-order coefficients and a natural-order quant table
    -> (n, 8, 8) uint8 samples, ``jpeg_idct_islow`` bit for bit."""
    dq = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (each column's 8 rows), 2 extra bits kept
    ws = _idct_1d([dq[:, k, :] for k in range(8)], 13 - 2)
    ws = np.stack(ws, 1)                       # (n, 8 rows, 8 cols)
    out = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(out, 2)                     # (n, rows, 8 outputs)
    return _RANGE[out & 1023]


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """h2v1 fancy upsampling of (rows, w) uint8, w > 2."""
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _colsums(x: np.ndarray) -> np.ndarray:
    """(2 rows, w) int32: 3 x nearer row + the further row, for the output
    rows above (row - 1) and below (row + 1), edges replicated."""
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = 3 * x + up
    out[1::2] = 3 * x + down
    return out


def _fancy_v2(x: np.ndarray) -> np.ndarray:
    """h1v2 fancy upsampling."""
    s = _colsums(x.astype(np.int32))
    s[0::2] = (s[0::2] + 1) >> 2
    s[1::2] = (s[1::2] + 2) >> 2
    return s.astype(np.uint8)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """h2v2 fancy upsampling of (h, w) uint8, w > 2."""
    s = _colsums(x.astype(np.int32))
    left = np.concatenate([s[:, :1], s[:, :-1]], 1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
    out = np.empty((s.shape[0], 2 * s.shape[1]), np.int32)
    out[:, 0::2] = (3 * s + left + 8) >> 4
    out[:, 1::2] = (3 * s + right + 7) >> 4
    return out.astype(np.uint8)


def _upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    w = plane.shape[1]
    if (rh, rv) == (1, 1):
        return plane
    if (rh, rv) == (2, 1) and w > 2:
        return _fancy_h2(plane)
    if (rh, rv) == (1, 2):
        return _fancy_v2(plane)
    if (rh, rv) == (2, 2) and w > 2:
        return _fancy_h2v2(plane)
    return np.repeat(np.repeat(plane, rv, 0), rh, 1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with its 16-bit tables."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)
    half = 1 << 15
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of a JPEG file -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it."""
    if data[:2] != b"\xff\xd8":
        raise JpegError(f"{name}: not a JPEG file (no SOI marker)")
    qts: Dict[int, np.ndarray] = {}
    dcs: Dict[int, Tuple[bytes, bytes]] = {}
    acs: Dict[int, Tuple[bytes, bytes]] = {}
    progressive = False
    comps: List[_Component] = []
    coefs: List[list] = []
    comp_qt: Dict[int, np.ndarray] = {}
    W = H = 0
    restart = 0
    jfif = False
    adobe: Optional[int] = None
    p = 2
    while True:
        while p < len(data) and data[p] == 0xFF and p + 1 < len(data) \
                and data[p + 1] == 0xFF:
            p += 1                                   # fill bytes
        if p + 2 > len(data) or data[p] != 0xFF:
            raise JpegError(f"{name}: no marker at byte {p}")
        m = data[p + 1]
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            p += 2
            continue
        (length,) = struct.unpack(">H", data[p + 2:p + 4])
        body = data[p + 4:p + 2 + length]
        if len(body) != length - 2:
            raise JpegError(f"{name}: truncated segment 0xFF{m:02X}")
        p += 2 + length
        if m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDB:
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[q + 1:q + 1 + n],
                                     ">u2" if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = vals
                qts[tq] = nat
                q += 1 + n
        elif m == 0xC4:
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                bits = body[q + 1:q + 17]
                n = sum(bits)
                vals = body[q + 17:q + 17 + n]
                (acs if tc else dcs)[th] = (bytes(bits), bytes(vals))
                q += 17 + n
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif m in (0xC0, 0xC1, 0xC2):
            progressive = m == 0xC2
            prec, H, W, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise JpegError(f"{name}: {prec}-bit samples are not "
                                f"supported (8-bit are)")
            if H == 0:
                raise JpegError(f"{name}: a height set by a DNL marker is "
                                f"not supported")
            if nf not in (1, 3):
                raise JpegError(f"{name}: {nf} components are not "
                                f"supported (1 or 3 are)")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(nf)]
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                raise JpegError(f"{name}: bad sampling factors")
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-W // (8 * hmax))
            mcuy = -(-H // (8 * vmax))
            coefs = [[0] * (mcux * c.h * mcuy * c.v * 64) for c in comps]
        elif m in _SOF_NAMES:
            raise JpegError(f"{name}: {_SOF_NAMES[m]} JPEGs (marker "
                            f"0xFF{m:02X}) are not supported; baseline, "
                            f"extended sequential and progressive Huffman "
                            f"(SOF0 / SOF1 / SOF2) are")
        elif m == 0xDA:
            if not comps:
                raise JpegError(f"{name}: a scan before the frame header")
            ns = body[0]
            sel = []
            for i in range(ns):
                cs, t = body[1 + 2 * i], body[2 + 2 * i]
                idx = [c.cid for c in comps].index(cs)
                sel.append((idx, t >> 4, t & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if not progressive and (ss, se, a) != (0, 63, 0):
                raise JpegError(f"{name}: a sequential scan with spectral "
                                f"selection {ss}-{se} / approximation {a}")
            if progressive and not (ss == se == 0 or (
                    1 <= ss <= se <= 63 and ns == 1)):
                raise JpegError(f"{name}: a progressive scan with spectral "
                                f"selection {ss}-{se} over {ns} components")
            tabs, order = [], []
            for j, (idx, td, ta) in enumerate(sel):
                need_dc = not progressive or (ss == 0 and ah == 0)
                need_ac = not progressive or ss > 0
                if (need_dc and td not in dcs) or (need_ac and ta not in acs):
                    raise JpegError(f"{name}: a scan names an undefined "
                                    f"Huffman table")
                if comps[idx].tq not in qts:
                    raise JpegError(f"{name}: a component's quantisation "
                                    f"table is undefined")
                comp_qt.setdefault(idx, qts[comps[idx].tq])
                if progressive:
                    tabs.append((_symbols(*dcs[td]) if need_dc else None,
                                 _symbols(*acs[ta]) if need_ac else None,
                                 coefs[idx]))
                else:
                    tabs.append((_tables(*dcs[td], False),
                                 _tables(*acs[ta], True), coefs[idx]))
            if ns == 1:
                idx = sel[0][0]
                c = comps[idx]
                bw = mcux * c.h
                nbx = -(-(-(-W * c.h // hmax)) // 8)
                nby = -(-(-(-H * c.v // vmax)) // 8)
                by, bx = np.divmod(np.arange(nby * nbx), nbx)
                bases = ((by * bw + bx) * 64).tolist()
                order = [(0, b) for b in bases]
                per = restart or len(order)
            else:
                parts = []
                for j, (idx, _, _) in enumerate(sel):
                    c = comps[idx]
                    my, mx, v, h = np.meshgrid(
                        np.arange(mcuy), np.arange(mcux), np.arange(c.v),
                        np.arange(c.h), indexing="ij")
                    base = ((my * c.v + v) * (mcux * c.h) + mx * c.h + h) * 64
                    parts.append((np.full(base.shape[2:], j),
                                  base.reshape(mcuy * mcux, -1)))
                js = np.concatenate([np.broadcast_to(
                    pj.reshape(-1), (mcuy * mcux, pj.size)) for pj, _ in
                    parts], 1).reshape(-1)
                bs = np.concatenate([b for _, b in parts], 1).reshape(-1)
                order = list(zip(js.tolist(), bs.tolist()))
                bpm = sum(comps[idx].h * comps[idx].v for idx, _, _ in sel)
                per = (restart * bpm) if restart else len(order)
            segs, p = _segments(data, p)
            if progressive:
                _decode_progressive(segs, order, per, tabs, name, ss, se,
                                    ah, al)
            else:
                _decode_scan(segs, order, per, tabs, coefs, name)
        elif m == 0xDC:
            raise JpegError(f"{name}: DNL markers are not supported")
        # APPn, COM and anything else with a length: skipped
        if p >= len(data):
            raise JpegError(f"{name}: no EOI marker")
    if not comps:
        raise JpegError(f"{name}: no frame header")
    if len(comp_qt) != len(comps):
        raise JpegError(f"{name}: a component has no scan")

    planes = []
    for idx, c in enumerate(comps):
        bw, bh = mcux * c.h, mcuy * c.v
        zz = np.array(coefs[idx], np.int64).reshape(bh * bw, 64)
        nat = np.empty_like(zz)
        nat[:, ZIGZAG] = zz
        blocks = idct_islow(nat, comp_qt[idx]).reshape(bh, bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        dw, dh = -(-W * c.h // hmax), -(-H * c.v // vmax)
        plane = _upsample(plane[:dh, :dw], hmax // c.h, vmax // c.v)
        if hmax % c.h or vmax % c.v:
            raise JpegError(f"{name}: non-integral sampling ratios")
        planes.append(plane[:H, :W])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, -1)
    ids = tuple(c.cid for c in comps)
    rgb = (not jfif and adobe == 0) or \
        (not jfif and adobe is None and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


# ----------------------------------------------------------------------
# the encoder
# ----------------------------------------------------------------------

# the IJG base tables (JPEG standard K.1 / K.2), zigzag order
_BASE_QT = (bytes.fromhex(
    "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740"
    "485c4e404457453738506d51575f626768673e4d71797064785c656763"),
    bytes.fromhex("1112121815182f1a1a2f634238426363" + "63" * 48))
# the standard Huffman tables (K.3 - K.6): (bits, values)
_STD_HUFF = {
    "dc0": ("00010501010101010100000000000000", "000102030405060708090a0b"),
    "dc1": ("00030101010101010101010000000000", "000102030405060708090a0b"),
    "ac0": ("0002010303020403050504040000017d",
            "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
            "2433627282090a161718191a25262728292a3435363738393a43444546474849"
            "4a535455565758595a636465666768696a737475767778797a83848586878889"
            "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
            "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
            "f9fa"),
    "ac1": ("00020102040403040705040400010277",
            "000102031104052131061241510761711322328108144291a1b1c109233352f0"
            "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
            "494a535455565758595a636465666768696a737475767778797a828384858687"
            "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
            "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
            "f9fa")}


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The two zigzag-order quant tables libjpeg writes at ``quality``
    (``jpeg_quality_scaling``, baseline: entries clamped to 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((np.frombuffer(b, np.uint8).astype(np.int64) * scale
                          + 50) // 100, 1, 255) for b in _BASE_QT)


def _encoder_codes(key: str) -> Tuple[np.ndarray, np.ndarray]:
    """(code, code length) indexed by symbol (0..255) of a standard table."""
    bits, vals = (bytes.fromhex(s) for s in _STD_HUFF[key])
    lengths, codes, syms = _canonical(bits, vals)
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    code[syms], size[syms] = codes, lengths
    return code, size


def _rgb_to_ycc(rgb: np.ndarray) -> Tuple[np.ndarray, ...]:
    """jccolor.c's rgb_ycc_convert (16 fraction bits)."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
          - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
          - 1) >> 16
    return y, cb, cr


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    m[0] *= 1 / math.sqrt(2)
    return m


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 bh, 8 bw) -> (bh, bw, 64) row-major blocks."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) \
        .reshape(bh, bw, 64)


def _quantize(blocks: np.ndarray, qt_zz: np.ndarray) -> np.ndarray:
    """(n, 64) samples -> (n, 64) quantised coefficients, zigzag order."""
    x = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    f = np.einsum("ux,nxy,vy->nuv", _DCT, x, _DCT).reshape(-1, 64)
    return np.round(f[:, ZIGZAG] / qt_zz).astype(np.int64)


def _bit_size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _mag_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v + (1 << s) - 1, v)


def _entropy(zz: np.ndarray, pred: np.ndarray, comp: np.ndarray,
             tables) -> bytes:
    """Huffman-code (n, 64) zigzag blocks in decode order: ``pred`` (n,)
    is each block's component (its DC is predicted from that component's
    previous block), ``comp`` (n,) its table set (0 luma, 1 chroma).
    Returns the stuffed entropy-coded bytes."""
    n = len(zz)
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(pred).tolist():
        at = np.flatnonzero(pred == c)
        diff[at] = np.diff(dc[at], prepend=0)
    keys, vals, lens = [], [], []

    def add(block, slot, value, length):
        keys.append(block * 256 + slot)
        vals.append(value)
        lens.append(length)

    blk = np.arange(n)
    s = _bit_size(diff)
    dcode = np.stack([tables[c][0] for c in (0, 1)])
    dsize = np.stack([tables[c][1] for c in (0, 1)])
    acode = np.stack([tables[c][2] for c in (0, 1)])
    asize = np.stack([tables[c][3] for c in (0, 1)])
    add(blk, 0, (dcode[comp, s] << s) | _mag_bits(diff, s),
        dsize[comp, s] + s)
    # AC: every non-zero coefficient, with the run of zeros before it
    ac = zz[:, 1:]
    bi, ki = np.nonzero(ac)
    k = ki + 1
    prev = np.zeros_like(k)
    same = np.zeros(len(bi), bool)
    same[1:] = bi[1:] == bi[:-1]
    prev[same] = k[:-1][same[1:]]
    run = k - prev - 1
    v = ac[bi, ki]
    s = _bit_size(v)
    c = comp[bi]
    sym = ((run % 16) << 4) | s
    add(bi, 2 * k, (acode[c, sym] << s) | _mag_bits(v, s),
        asize[c, sym] + s)
    nzrl = run // 16
    zb = np.repeat(bi, nzrl)
    zk = np.repeat(k, nzrl)
    zc = comp[zb]
    add(zb, 2 * zk - 1, acode[zc, 0xF0], asize[zc, 0xF0])
    # EOB unless the block's last coefficient is non-zero
    last = np.zeros(n, np.int64)
    last[bi] = k                                # the last write wins
    eb = np.flatnonzero(last < 63)
    add(eb, 255, acode[comp[eb], 0], asize[comp[eb], 0])

    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    total = int(ln.sum())
    starts = np.cumsum(ln) - ln
    item = np.repeat(np.arange(len(ln)), ln)
    j = np.arange(total) - starts[item]
    bits = ((val[item] >> (ln[item] - 1 - j)) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])   # 1-bit fill
    out = np.packbits(bits)
    ff = out == 0xFF
    stuffed = np.zeros(len(out) + int(ff.sum()), np.uint8)
    at = np.arange(len(out)) + np.cumsum(ff) - ff
    stuffed[at] = out
    return stuffed.tobytes()


QUALITY = 75


def encode_jpeg(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of a baseline JFIF JPEG, quality
    75, 4:2:0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    H, W = img.shape[:2]
    mcux, mcuy = -(-W // 16), -(-H // 16)          # 16 x 16 MCUs
    y, cb, cr = _rgb_to_ycc(img)
    # replicate the right column and the bottom row out to whole MCUs
    pw, ph = mcux * 16, mcuy * 16

    def pad(p):
        return np.pad(p, ((0, ph - H), (0, pw - W)), mode="edge")

    y, cb, cr = pad(y), pad(cb), pad(cr)
    # jcsample.c's h2v2_downsample: the 2 x 2 sum plus a bias of 1, 2, 1,
    # 2, ... along the row, then >> 2
    bias = np.tile([1, 2], pw // 4)

    def down(p):
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        return (s + bias) >> 2

    cb, cr = down(cb), down(cr)
    qy, qc = quality_tables(QUALITY)
    by = _quantize(_blocks(y), qy)
    bcb = _quantize(_blocks(cb), qc)
    bcr = _quantize(_blocks(cr), qc)
    # decode order: each MCU's 2 x 2 luma blocks, then one Cb and one Cr
    ybl = by.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(mcuy * mcux, 4, 64)
    mcu = np.concatenate([ybl, bcb.reshape(-1, 1, 64),
                          bcr.reshape(-1, 1, 64)], 1)
    pred = np.tile(np.r_[np.zeros(4, np.int64), 1, 2], mcuy * mcux)
    tables = [(*_encoder_codes("dc0"), *_encoder_codes("ac0")),
              (*_encoder_codes("dc1"), *_encoder_codes("ac1"))]
    scan = _entropy(mcu.reshape(-1, 64), pred, np.minimum(pred, 1), tables)

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8"
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDB, b"\x00" + qy.astype(np.uint8).tobytes()
               + b"\x01" + qc.astype(np.uint8).tobytes())
    out += seg(0xC0, struct.pack(">BHHB", 8, H, W, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls, th, key in ((0, 0, "dc0"), (1, 0, "ac0"), (0, 1, "dc1"),
                         (1, 1, "ac1")):
        bits, vals = (bytes.fromhex(s) for s in _STD_HUFF[key])
        out += seg(0xC4, bytes([(cls << 4) | th]) + bits + vals)
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + scan + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img))
