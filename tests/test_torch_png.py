"""The port's PNG codec (``deepcharuco_tpu_torch/data/png.py``) against cv2
5.0.0 on the CPU: every colour type and bit depth the format has, each of
the five row filters and a mix of them, plain and Adam7-interlaced, read
bit-equal to ``cv2.imread(IMREAD_COLOR)``; files that cv2 writes read by
the port and files that the port writes read by cv2, bit-equal; the gray
read; and the two readers of the port that now take ``.png`` without cv2.

The test files are written by :func:`encode_reference`, a plain loop over
rows and bytes that applies the filter a test asks for (cv2 writes neither
palettes nor interlaced files nor chosen filters).
"""

import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from deepcharuco_tpu_torch.data import png  # noqa: E402

# colour type → (channels, bit depths)
TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
         6: (4, (8, 16))}
CASES = [(ct, d) for ct, (_, depths) in TYPES.items() for d in depths]
MIXED = -1      # filter of row i is i % 5


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_rows(rows, bpp, ftype):
    out, prev = [], bytes(len(rows[0]))
    for i, r in enumerate(rows):
        ft = i % 5 if ftype == MIXED else ftype
        o = bytearray([ft])
        for x in range(len(r)):
            a = r[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (
                b if abs(p - b) <= abs(p - c) else c)
            o.append((r[x] - (0, a, b, (a + b) // 2, paeth)[ft]) & 255)
        out.append(bytes(o))
        prev = r
    return b"".join(out)


def _pack_rows(samples, depth):
    rows = []
    for row in samples:
        s = row.reshape(-1)
        if depth == 16:
            rows.append(s.astype(">u2").tobytes())
        elif depth == 8:
            rows.append(s.astype(np.uint8).tobytes())
        else:
            bits = np.unpackbits(s.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
            rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


def encode_reference(samples, depth, ctype, ftype, interlace, palette=None):
    """PNG bytes of (h, w, c) integer samples, every row filtered by
    ``ftype`` (or the mix), Adam7 when ``interlace``."""
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        data = b"".join(_filter_rows(_pack_rows(samples[y0::dy, x0::dx], depth), bpp, ftype)
                        for y0, x0, dy, dx in png._ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        data = _filter_rows(_pack_rows(samples, depth), bpp, ftype)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", CASES)
def test_every_colour_type_depth_filter_and_interlace_reads_as_cv2(tmp_path, ctype, depth):
    """Bit-equal to ``cv2.imread(IMREAD_COLOR)`` for each of the five
    filters, the mix, plain and interlaced (16-bit keeps the high byte,
    alpha is dropped, a palette is looked up, low-depth gray scaled)."""
    rng = np.random.default_rng(ctype * 100 + depth)
    channels = TYPES[ctype][0]
    palette = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8) if ctype == 3 else None
    path = tmp_path / "x.png"
    for ftype in (0, 1, 2, 3, 4, MIXED):
        for interlace in (False, True):
            samples = rng.integers(0, 1 << depth, (13, 17, channels))
            path.write_bytes(encode_reference(samples, depth, ctype, ftype, interlace, palette))
            want = cv2.imread(str(path), cv2.IMREAD_COLOR)
            got = png.read_png(path)
            assert want is not None and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"filter {ftype} "
                                                             f"interlace {interlace}")


@pytest.mark.parametrize("shape", [(240, 320), (480, 640, 3), (7, 5), (33, 47, 3)])
def test_cv2_and_the_port_read_each_others_files(tmp_path, shape):
    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] //= 16            # smooth and noisy rows: several filters win
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    want = cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(png.read_png(tmp_path / "cv2.png"), want)
    png.write_png(tmp_path / "port.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "port.png"), want)


def test_sixteen_bit_and_interlaced_files_that_cv2_writes(tmp_path):
    rng = np.random.default_rng(3)
    img16 = rng.integers(0, 65536, (31, 45, 3), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "16.png"), img16)
    np.testing.assert_array_equal(png.read_png(tmp_path / "16.png"),
                                  cv2.imread(str(tmp_path / "16.png"), cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(png.read_png(tmp_path / "16.png"), (img16 >> 8).astype(np.uint8))
    # an interlaced RGB file with every filter in turn, 240×320 (the frames' size)
    samples = rng.integers(0, 256, (240, 320, 3))
    (tmp_path / "i.png").write_bytes(encode_reference(samples, 8, 2, MIXED, True))
    np.testing.assert_array_equal(png.read_png(tmp_path / "i.png"),
                                  cv2.imread(str(tmp_path / "i.png"), cv2.IMREAD_COLOR))


def test_gray_read(tmp_path):
    """``read_png_gray`` is ``cvtColor(imread(path), BGR2GRAY)`` (what the
    JAX CLIs read) for every file, and ``imread(IMREAD_GRAYSCALE)`` for a
    gray one (for colour files libpng's own conversion differs by a level)."""
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (24, 40), dtype=np.uint8)
    bgr = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "g.png"), gray)
    cv2.imwrite(str(tmp_path / "c.png"), bgr)
    np.testing.assert_array_equal(png.read_png_gray(tmp_path / "g.png"),
                                  cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE))
    for name in ("g.png", "c.png"):
        np.testing.assert_array_equal(
            png.read_png_gray(tmp_path / name),
            cv2.cvtColor(cv2.imread(str(tmp_path / name)), cv2.COLOR_BGR2GRAY))


def test_malformed_files_raise(tmp_path):
    (tmp_path / "a.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "a.png")
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4), np.float32))


def test_the_port_reads_png_without_cv2(tmp_path, monkeypatch):
    """``data.sources._imread`` and ``cli.read_frames`` take ``.png`` with
    cv2 unimportable; other formats still name cv2."""
    from deepcharuco_tpu_torch.cli import read_frames
    from deepcharuco_tpu_torch.data.sources import _imread

    img = np.random.default_rng(5).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_imread(str(tmp_path / "a.png")), img)
    (name, frame), = read_frames([str(tmp_path / "*.png")])
    assert name.endswith("a.png")
    np.testing.assert_array_equal(frame, img)
    (tmp_path / "b.jpg").write_bytes(b"x")
    with pytest.raises(SystemExit, match="needs OpenCV"):
        _imread(str(tmp_path / "b.jpg"))


def test_pose_video_reads_a_png_directory_without_cv2(tmp_path, monkeypatch):
    from deepcharuco_tpu_torch.cli import pose_video

    cfg = tmp_path / "small.yaml"
    cfg.write_text("board_name: DICT_4X4_50\nrow_count: 5\ncol_count: 5\nsquare_len: 0.01\n"
                   "marker_len: 0.0075\ninput_size: [96, 64]\n")
    frames = np.random.default_rng(6).integers(0, 255, (3, 64, 96), dtype=np.uint8)
    for i, f in enumerate(frames):
        png.write_png(tmp_path / f"f{i}.png", f)
    np.save(tmp_path / "frames.npy", np.repeat(frames[..., None], 3, axis=-1))
    monkeypatch.setitem(sys.modules, "cv2", None)
    base = ["--config", str(cfg), "--no-video", "--device", "cpu"]
    from_png = pose_video.main([str(tmp_path)] + base)
    from_npy = pose_video.main([str(tmp_path / "frames.npy")] + base)
    assert len(from_png) == len(from_npy) == 3
    for a, b in zip(from_png, from_npy):
        assert repr(a) == repr(b)
