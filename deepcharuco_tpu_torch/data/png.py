"""PNG files in numpy and ``zlib``: what ``cv2.imread`` and ``cv2.imwrite``
do for ``.png`` on the paths of the port's CLIs, for the card's machine,
which has no cv2.

- :func:`read_png` gives what ``cv2.imread(path, cv2.IMREAD_COLOR)`` gives:
  BGR uint8 (H, W, 3). It reads bit depths 1, 2, 4, 8 and 16, colour types
  gray, gray + alpha, RGB, RGBA and palette, all five row filters, and
  Adam7 interlacing. As cv2 does it (libpng under ``IMREAD_COLOR``): 16-bit
  samples keep their high byte, alpha is dropped (not composited), gray is
  repeated into the three channels, a palette is looked up.
- :func:`read_png_gray` is ``cv2.cvtColor(read_png(path), COLOR_BGR2GRAY)``
  through :func:`cvnp.bgr2gray`, which for a gray file is its samples and
  equals ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``.
- :func:`write_png` writes a uint8 gray or BGR image that cv2 (and this
  reader) reads back bit-equal; each row gets the filter with the least sum
  of absolute values, as libpng chooses by default.

The filters are undone on all rows at once along anti-diagonals of pixels
(a pixel depends on its left, upper and upper-left neighbours only), so
the Python loop runs H + W times, not H·W. ``tests/test_torch_png.py``
holds the reader and the writer to cv2 5.0.0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from deepcharuco_tpu_torch.data import cvnp

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type → samples per pixel
# Adam7: (row start, column start, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the row filters of one image (or one Adam7 pass): ``raw`` holds
    ``height`` rows of a filter byte and ``row_bytes`` bytes. → (height,
    row_bytes) uint8. ``bpp`` is the bytes per complete pixel (at least 1)."""
    rows = raw[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    kinds = rows[:, 0].astype(np.int64)
    if np.any(kinds > 4):
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    filt = rows[:, 1:].astype(np.int64)
    if np.all(kinds == 0):
        return filt.astype(np.uint8)
    px = -(-row_bytes // bpp)
    pad = px * bpp - row_bytes
    # (height + 1, px + 1, bpp): a zero row above and a zero pixel to the left
    out = np.zeros((height + 1, px + 1, bpp), np.int64)
    f = np.pad(filt, ((0, 0), (0, pad))).reshape(height, px, bpp)
    y = np.arange(height)
    for d in range(height + px - 1):             # anti-diagonal y + x = d
        ys = y[max(0, d - px + 1):min(height, d + 1)]
        xs = d - ys
        a = out[ys + 1, xs]                      # left
        b = out[ys, xs + 1]                      # up
        c = out[ys, xs]                          # up-left
        k = kinds[ys][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return out[1:, 1:].reshape(height, px * bpp)[:, :row_bytes].astype(np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unpacked rows → (h, width, channels) samples (uint8, or uint16 at
    depth 16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        v = rows[:, :width * channels * 2].reshape(h, width * channels, 2).astype(np.uint16)
        return ((v[..., 0] << 8) | v[..., 1]).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1).astype(np.uint8)[..., None]


def decode_png(data: bytes):
    """The samples of a PNG file and its header: ``(samples, info)`` with
    samples (H, W, C) uint8 or uint16 (C as stored: 1, 2, 3 or 4, palette
    indices for colour type 3) and info a dict of ``color_type``,
    ``bit_depth``, ``palette`` ((n, 3) uint8 or None)."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG colour type {ctype} at depth {depth}")
    channels = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    bits = depth * channels
    bpp = max(1, bits // 8)
    row_bytes = lambda w: (w * bits + 7) // 8
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace == 0:
        rows = _unfilter(raw, height, row_bytes(width), bpp)
        img = _samples(rows, width, depth, channels)
    else:
        img = np.zeros((height, width, channels), dtype)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = -(-(height - y0) // dy), -(-(width - x0) // dx)
            if ph <= 0 or pw <= 0:
                continue
            size = ph * (row_bytes(pw) + 1)
            rows = _unfilter(raw[pos:pos + size], ph, row_bytes(pw), bpp)
            img[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
            pos += size
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    return img, {"color_type": ctype, "bit_depth": depth, "palette": palette}


def _to_bgr(img: np.ndarray, info: dict) -> np.ndarray:
    if info["color_type"] == 3:
        rgb = info["palette"][np.minimum(img[..., 0], len(info["palette"]) - 1)]
        return np.ascontiguousarray(rgb[..., ::-1])
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    elif info["bit_depth"] < 8:                  # gray at 1, 2 or 4 bits: scaled to 0..255
        img = (img.astype(np.uint16) * (255 // ((1 << info["bit_depth"]) - 1))).astype(np.uint8)
    if info["color_type"] in (0, 4):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def read_png(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` for a PNG file: (H, W, 3) BGR
    uint8. Raises ``ValueError`` for a file that is not a PNG."""
    with open(path, "rb") as f:
        data = f.read()
    return _to_bgr(*decode_png(data))


def read_png_gray(path) -> np.ndarray:
    """The gray frame the JAX CLIs read (``cvtColor(imread(path),
    COLOR_BGR2GRAY)``): (H, W) uint8."""
    return cvnp.bgr2gray(read_png(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """A uint8 (H, W) gray or (H, W, 3) BGR image as PNG bytes (8-bit gray
    or RGB, not interlaced)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                          and img.shape[2] not in (1, 3)):
        raise ValueError(f"expected a uint8 (H, W) or (H, W, 3) image, got {img.dtype} "
                         f"{img.shape}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    ctype, bpp = (0, 1) if img.ndim == 2 else (2, 3)
    x = (img if img.ndim == 2 else img[..., ::-1]).reshape(h, -1).astype(np.int64)
    a = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]               # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]                      # up
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]               # up-left
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)]) & 0xFF
    signed = np.where(cand > 127, 256 - cand, cand).sum(axis=2)          # (5, h)
    kind = signed.argmin(axis=0)
    rows = np.concatenate([kind[:, None], cand[kind, np.arange(h)]], axis=1).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 3)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a ``.png`` path and a uint8 gray or
    BGR image."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
