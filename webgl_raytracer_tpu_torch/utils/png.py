"""PNG encode/decode for RGB8 images with the standard library alone
(zlib + struct), and the nearest-neighbour upsample of the viewer's
preview.

The JAX package writes its PNGs through Pillow; the port needs no Pillow.
encode_png writes one IHDR (8-bit RGB, no interlace), one IDAT whose
scanlines all use filter 0, and IEND. decode_png reads back exactly that
form (any split of the IDAT data), which is what the tests and the smoke
run check the served frames with.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ZLIB_LEVEL = 6          # zlib's own default


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(image_u8: np.ndarray) -> bytes:
    """u8[H,W,3] -> PNG bytes (RGB8, filter 0 on every scanline)."""
    img = np.ascontiguousarray(image_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected u8[H,W,3], got shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # column 0: filter type 0
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes of the form encode_png writes -> u8[H,W,3]. Raises
    ValueError on anything else (another colour type or bit depth,
    interlace, a scanline filter other than 0, a bad CRC)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    at, header, idat = 8, None, []
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        at += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"unsupported PNG form: depth {depth}, colour type {colour}, "
                         f"interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("unsupported scanline filter")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source index of each of n_out samples: the position starts at half
    a step and advances one step (n_in / n_out) a sample, accumulated in
    f64 as Pillow's Image.NEAREST resize does (a sequential cumsum), then
    truncated."""
    step = n_in / n_out
    pos = np.full(n_out, step)
    pos[0] = 0.5 * step
    return np.minimum(np.cumsum(pos).astype(np.int64), n_in - 1)


def upsample_nearest(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour resize of u8[h,w,3] to [height,width,3], sampled
    as the JAX viewer's Pillow Image.NEAREST resize samples."""
    h, w = image.shape[:2]
    return image[_nearest_index(height, h)[:, None], _nearest_index(width, w)[None, :]]
