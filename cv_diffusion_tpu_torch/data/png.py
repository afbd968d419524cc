"""Image files in numpy and the standard library: PNG decode and encode, BMP
decode.

The JAX package reads and writes images with Pillow
(``cv_diffusion_tpu/data/dataset.py:55-56``, ``data/device_cache.py:60-70``,
``training/trainer.py:56-69``), which the port does not depend on. This
module decodes to what ``np.array(Image.open(path).convert("RGB"))`` gives:

* PNG of every colour type and bit depth, palette with or without ``tRNS``,
  Adam7 interlace, all five row filters. Alpha and ``tRNS`` are dropped, as
  ``convert("RGB")`` drops them. Samples are reduced to 8 bits as Pillow
  reduces each mode: 16-bit RGB, RGBA and gray+alpha keep the high byte;
  16-bit gray (Pillow's ``I;16``) is clipped to 255; gray of 1, 2 or 4 bits
  is scaled to 0..255.
* BMP, uncompressed 24-bit and 32-bit (``BI_RGB``, or ``BI_BITFIELDS`` with
  byte-aligned masks), bottom-up or top-down.
* JPEG is refused: decoding it needs libjpeg, which the native loader
  (``data/native.py``) links.

Row filters Sub, Average and Paeth take the left neighbour, so a row cannot
be undone in one vector operation. :func:`_unfilter` runs over anti-diagonal
wavefronts instead: unit x of row y depends only on units of rows y and
y − 1 at columns < x + 1, so every (y, x) with y + x = d is ready once the
wavefront d − 1 is, and an image takes H + U − 1 vector steps (U units a
row) in a skewed copy where each wavefront is contiguous; every predictor
is one lookup in a table indexed by the filter, b − c and a − c.
:func:`read_images` unfilters files of one geometry together, K images a
step, so that numpy's per-call cost is paid once for all of them.
"""

from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of K images at once: ``rows`` [K, H, 1 +
    rowbytes] holds each row's filter type, then the filtered row; ``bpp``
    bytes make one unit, the distance to the left neighbour. Returns uint8
    [K, H, rowbytes]."""
    k, height, width = rows.shape
    rowbytes = width - 1
    ftype = rows[..., 0]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    raw = rows[..., 1:]
    units = rowbytes // bpp
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up only: a row at a time, Sub as a running sum
        out = np.empty((k, height, rowbytes), np.uint8)
        prior = np.zeros((k, rowbytes), np.uint8)
        for y in range(height):
            row, f = raw[:, y], ftype[:, y, None]
            sub = np.cumsum(row.reshape(k, units, bpp), axis=1,
                            dtype=np.uint8).reshape(k, rowbytes)
            out[:, y] = np.where(f == 1, sub, np.where(f == 2, row + prior, row))
            prior = out[:, y]
        return out
    # Wavefronts. S holds the decoded units skewed and wavefront-major:
    # image row y, unit x at S[x + y + 2, :, y + 1], so wavefront d = y + x
    # is S[d + 2]; row 0 and wavefronts 0-1 stay zero (the missing upper and
    # left neighbours).
    cols = height + units + 1
    S = np.zeros((cols, k, height + 1, bpp), np.int32)
    R = np.zeros((cols, k, height, bpp), np.int32)

    def skewed(a, first):
        col, img, row, item = a.strides
        return np.lib.stride_tricks.as_strided(
            a[2:, :, first:], (k, height, units, bpp),
            (img, col + row, col, item), writeable=True)

    skewed(R, 0)[:] = raw.reshape(k, height, units, bpp)
    # every predictor but None is c + a function of (b − c, a − c): one
    # table lookup a unit, indexed from each row's filter
    lut = _predictor_table()
    f = np.broadcast_to(ftype.astype(np.int32)[..., None], (k, height, bpp))
    base = f * _SPAN * _SPAN + 255 * _SPAN + 255
    keep_c = (f != 0).astype(np.int32)
    for d in range(height + units - 1):
        lo, hi = max(0, d - units + 1), min(height - 1, d) + 1
        left = S[d + 1]
        a = left[:, lo + 1:hi + 1]
        b = left[:, lo:hi]
        c = S[d, :, lo:hi]
        idx = b - c
        idx *= _SPAN
        idx += a
        idx -= c
        idx += base[:, lo:hi]
        v = lut.take(idx)
        v += c * keep_c[:, lo:hi]
        v += R[d + 2, :, lo:hi]
        v &= 0xFF
        S[d + 2, :, lo + 1:hi + 1] = v
    return skewed(S, 1).astype(np.uint8).reshape(k, height, rowbytes)


_SPAN = 511          # b − c and a − c each lie in [−255, 255]


@functools.lru_cache(maxsize=1)
def _predictor_table() -> np.ndarray:
    """T[f, p1 + 255, p2 + 255] with p1 = b − c, p2 = a − c, flattened and
    read-only: the predictor of filter f minus c (None's row is 0 and its c
    is masked off). Paeth picks a, b or c by |b − c|, |a − c| and
    |a + b − 2c| = |p1 + p2|; the average is c + ⌊(p1 + p2) / 2⌋."""
    p1, p2 = np.meshgrid(np.arange(-255, 256), np.arange(-255, 256),
                         indexing="ij")
    pa, pb, pc = np.abs(p1), np.abs(p2), np.abs(p1 + p2)
    paeth = np.where((pa <= pb) & (pa <= pc), p2, np.where(pb <= pc, p1, 0))
    table = np.stack([np.zeros_like(p1), p2, p1, (p1 + p2) >> 1, paeth])
    table = table.astype(np.int32).reshape(-1)
    table.flags.writeable = False
    return table


def _samples(rows: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """Unfiltered rows → samples [h, width, channels] (uint8, or uint16
    for 16 bits)."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.reshape(h, width, channels, 2).astype(np.uint16) @ \
            np.array([256, 1], np.uint16)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits @ weights).astype(np.uint8)[..., None]


def _to_rgb8(s: np.ndarray, color: int, depth: int,
             palette: Optional[np.ndarray]) -> np.ndarray:
    """Samples → uint8 [h, w, 3] as Pillow's ``convert("RGB")``."""
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        full = np.zeros((256, 3), np.uint8)     # Pillow pads with black
        full[:len(palette)] = palette
        return full[s[..., 0]]
    if depth == 16:
        # I;16 (gray) clips to 255; the other modes keep the high byte
        s = (np.minimum(s, 255) if color == 0 else s >> 8).astype(np.uint8)
    elif depth < 8:
        s = (s.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if color in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def _parse_png(data: bytes):
    """(IHDR fields, palette, the decompressed image data) of a PNG."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise ValueError(f"PNG: colour type {color} at {depth} bits")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return (width, height, depth, color, interlace), palette, raw


def _rowbytes(w: int, channels: int, depth: int) -> int:
    return (w * channels * depth + 7) // 8


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes → uint8 RGB [H, W, 3]."""
    return decode_pngs([data])[0]


def decode_pngs(datas: Sequence[bytes]) -> List[np.ndarray]:
    """Many PNG files' bytes → uint8 RGB arrays. Non-interlaced files of one
    geometry are unfiltered together, one wavefront pass for all of them,
    which spreads numpy's per-call cost over the group."""
    parsed = [_parse_png(d) for d in datas]
    out: List[Optional[np.ndarray]] = [None] * len(datas)
    groups: Dict[tuple, List[int]] = {}
    for i, (header, _, _) in enumerate(parsed):
        key = header if not header[4] else (i,)
        groups.setdefault(key, []).append(i)
    for members in groups.values():
        (width, height, depth, color, interlace), _, _ = parsed[members[0]]
        channels = _CHANNELS[color]
        bpp = max(1, channels * depth // 8)
        if not interlace:
            n = height * (_rowbytes(width, channels, depth) + 1)
            rows = np.stack([parsed[i][2][:n] for i in members]).reshape(
                len(members), height, -1)
            for i, r in zip(members, _unfilter(rows, bpp)):
                out[i] = _to_rgb8(_samples(r, width, channels, depth), color,
                                  depth, parsed[i][1])
            continue
        (i,) = members
        raw = parsed[i][2]
        samples = np.zeros((height, width, channels),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            if h == 0 or w == 0:
                continue
            n = h * (_rowbytes(w, channels, depth) + 1)
            rows = _unfilter(raw[pos:pos + n].reshape(1, h, -1), bpp)[0]
            pos += n
            samples[y0::dy, x0::dx] = _samples(rows, w, channels, depth)
        out[i] = _to_rgb8(samples, color, depth, parsed[i][1])
    return out


def decode_bmp(data: bytes) -> np.ndarray:
    """An uncompressed 24- or 32-bit BMP's bytes → uint8 RGB [H, W, 3]."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset, = struct.unpack("<I", data[10:14])
    header_size, = struct.unpack("<I", data[14:18])
    width, height, _, bits, compression = struct.unpack(
        "<iiHHI", data[18:34])
    masks = None
    if compression == 3 and bits == 32:        # BI_BITFIELDS
        if header_size >= 52:
            masks = struct.unpack("<III", data[54:66])
        else:
            masks = struct.unpack("<III", data[14 + header_size:26 + header_size])
    elif compression != 0 or bits not in (24, 32):
        raise ValueError(f"BMP: only uncompressed 24/32-bit files are read "
                         f"(this one: {bits} bits, compression {compression})")
    top_down = height < 0
    height = abs(height)
    step = (width * bits // 8 + 3) & ~3
    px = np.frombuffer(data, np.uint8, count=step * height, offset=offset)
    px = px.reshape(height, step)[:, :width * bits // 8]
    px = px.reshape(height, width, bits // 8)
    if not top_down:
        px = px[::-1]
    if masks is None:
        return np.ascontiguousarray(px[..., 2::-1])
    shifts = []
    for m in masks:
        shift = (m & -m).bit_length() - 1
        if m >> shift != 0xFF or shift % 8:
            raise ValueError(f"BMP: channel mask {m:#010x} is not one byte")
        shifts.append(shift // 8)
    return np.ascontiguousarray(px[..., shifts])


def _decode(data: bytes, path) -> np.ndarray:
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(
            f"{path}: JPEG is decoded only by the native loader (libjpeg; "
            "data/native.py, TrainConfig.native_loader); the numpy decoder "
            "reads PNG and BMP")
    raise ValueError(f"{path}: not a PNG or BMP file")


def read_image(path: Union[str, Path]) -> np.ndarray:
    """A PNG or BMP file → uint8 RGB [H, W, 3], as
    ``np.array(Image.open(path).convert("RGB"))``."""
    return read_images([path])[0]


def read_images(paths: Sequence[Union[str, Path]]) -> List[np.ndarray]:
    """:func:`read_image` of many files, the PNGs through
    :func:`decode_pngs`."""
    datas = [Path(p).read_bytes() for p in paths]
    out: List[Optional[np.ndarray]] = [None] * len(datas)
    pngs = [i for i, d in enumerate(datas) if d[:8] == PNG_SIGNATURE]
    for i, img in zip(pngs, decode_pngs([datas[i] for i in pngs])):
        out[i] = img
    for i, d in enumerate(datas):
        if out[i] is None:
            out[i] = _decode(d, paths[i])
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filters: Union[int, Sequence[int]] = 0
               ) -> bytes:
    """uint8 RGB [H, W, 3] → PNG bytes (8-bit RGB, not interlaced).
    ``filters`` is the row filter of every row, or one per row, cycled."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))
    ftype = np.resize(np.asarray(filters, np.uint8).reshape(-1), h)
    rows = np.empty((h, 1 + w * 3), np.uint8)
    rows[:, 0] = ftype
    for f in range(5):
        sel = ftype == f
        rows[sel, 1:] = (x[sel] - preds[f][sel]) & 0xFF
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Union[int, Sequence[int]] = 0) -> None:
    """:func:`encode_png` into the file ``path`` (its directory made)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img, filters))
