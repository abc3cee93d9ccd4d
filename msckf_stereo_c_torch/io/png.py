"""8-bit grayscale PNG in plain Python: the standard library's ``zlib`` and
numpy, no libpng, no OpenCV.

``decode_png`` reads the one format EuRoC's camera images use (8-bit
grayscale, non-interlaced) and gives exactly what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives for it.  Any other format
raises ``ValueError`` naming the file.  ``decode_pngs`` decodes several
images of one size together.  ``encode_png`` writes that format
with a chosen filter per row, so a test or a smoke run can make files whose
rows use every filter type.

PNG filters predict each byte from its left (a), upper (b) and upper-left
(c) neighbours of the decoded image.  None, Sub and Up rows vectorise
directly, but Avg and Paeth rows are a per-pixel recurrence along the row,
and libpng's adaptive writers may pick any filter for any row.  So the
decoder sweeps the image's anti-diagonals: every pixel on diagonal
d = x + y depends only on diagonals d - 1 and d - 2, so each of the
H + W - 1 steps decodes one diagonal at once, whatever the rows' filters.
"""
from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
SWEEP_IMAGES = 16  # images decoded by one sweep: spreads its per-step cost, bounds its memory


def _fail(path: str, what: str):
    raise ValueError(f"{path}: {what} (only 8-bit grayscale non-interlaced PNG is read)")


def _chunks(data: bytes, path: str):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        _fail(path, "not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            _fail(path, "truncated chunk header")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            _fail(path, f"truncated {ctype!r} chunk")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(ctype + payload) != crc:
            _fail(path, f"CRC mismatch in the {ctype!r} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4
    _fail(path, "no IEND chunk")


def _read_filtered(path: str):
    """The filtered rows (H, W) uint8 and their filter types (H,) of an
    8-bit grayscale non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype[0:1].isupper() and ctype != b"IEND":
            _fail(path, f"critical chunk {ctype!r}")
    if header is None:
        _fail(path, "no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if (depth, color, compression, filter_method, interlace) != (8, 0, 0, 0, 0):
        _fail(path, f"bit depth {depth}, color type {color}, interlace {interlace}")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        _fail(path, f"image data does not inflate ({e})")
    if raw.size != height * (width + 1):
        _fail(path, f"{raw.size} bytes of image data for {width}x{height}")
    raw = raw.reshape(height, width + 1)
    if (raw[:, 0] > 4).any():
        _fail(path, f"row filter type {int(raw[:, 0].max())}")
    return raw[:, 1:], raw[:, 0]


def decode_pngs(paths: Sequence[str]) -> np.ndarray:
    """The images of ``paths`` (all of one size) as one (N, H, W) uint8
    array, SWEEP_IMAGES of them to a sweep."""
    out = []
    for s0 in range(0, len(paths), SWEEP_IMAGES):
        group = [_read_filtered(p) for p in paths[s0 : s0 + SWEEP_IMAGES]]
        for p, (raw, _) in zip(paths[s0 : s0 + SWEEP_IMAGES], group):
            if raw.shape != group[0][0].shape:
                _fail(p, f"size {raw.shape[::-1]} differs from {group[0][0].shape[::-1]} of {paths[s0]}")
        if out and group[0][0].shape != out[0].shape[1:]:
            _fail(paths[s0], f"size {group[0][0].shape[::-1]} differs from {out[0].shape[:0:-1]} of {paths[0]}")
        out.append(_unfilter(np.stack([g[0] for g in group]), np.stack([g[1] for g in group])))
    return np.concatenate(out) if out else np.zeros((0, 0, 0), np.uint8)


def decode_png(path: str) -> np.ndarray:
    """The (H, W) uint8 image of an 8-bit grayscale non-interlaced PNG."""
    return decode_pngs([path])[0]


def _paeth_predict(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 neighbours, ties to a, then b."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters of N images, raw (N, H, W) with filter types
    (N, H), by a sweep over anti-diagonals.

    ``sk[d, :, y + 1]`` holds pixel (y, x = d - y) and column 0 is the zero
    row above the image, so a diagonal's left and upper neighbours are one
    row of ``sk`` back and its upper-left two rows back."""
    N, H, W = raw.shape
    D = H + W - 1
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    rs = np.zeros((D, N, H), np.int16)  # filtered bytes by diagonal
    rs[ys + xs, :, ys] = raw.transpose(1, 2, 0)
    sk = np.zeros((D + 2, N, H + 1), np.int16)  # two zero diagonals in front
    is_sub, is_up, is_avg, is_paeth = (ftype == 1), (ftype == 2), (ftype == 3), (ftype == 4)
    for d in range(D):
        y0, y1 = max(0, d - W + 1), min(H, d + 1)
        a = sk[d + 1, :, y0 + 1 : y1 + 1]  # left: (y, x - 1) on diagonal d - 1
        b = sk[d + 1, :, y0:y1]  # up: (y - 1, x) on diagonal d - 1
        c = sk[d, :, y0:y1]  # upper-left: (y - 1, x - 1) on diagonal d - 2
        sl = slice(y0, y1)
        pred = np.where(
            is_paeth[:, sl], _paeth_predict(a, b, c),
            np.where(is_avg[:, sl], (a + b) >> 1, a * is_sub[:, sl] + b * is_up[:, sl]),
        )
        sk[d + 2, :, y0 + 1 : y1 + 1] = (rs[d, :, y0:y1] + pred) & 0xFF
    return sk[ys + xs + 2, :, ys + 1].transpose(2, 0, 1).astype(np.uint8)


def encode_png(path: str, img: np.ndarray, filters: Sequence[int] = (0,)) -> None:
    """Write the (H, W) uint8 ``img`` as an 8-bit grayscale PNG; row y uses
    filter ``filters[y % len(filters)]`` (0 none, 1 sub, 2 up, 3 average,
    4 paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"encode_png takes a 2-D uint8 image, got {img.dtype} {img.shape}")
    H, W = img.shape
    x = img.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :W]
    b = np.pad(x, ((1, 0), (0, 0)))[:H]
    c = np.pad(x, ((1, 0), (1, 0)))[:H, :W]
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth_predict(a, b, c))
    ftype = np.asarray([filters[y % len(filters)] for y in range(H)], np.uint8)
    out = np.empty((H, W + 1), np.uint8)
    out[:, 0] = ftype
    for f in range(5):
        rows = ftype == f
        out[rows, 1:] = ((x - preds[f])[rows] & 0xFF).astype(np.uint8)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(ctype + payload))

    header = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(out.tobytes()))
                + chunk(b"IEND", b""))
