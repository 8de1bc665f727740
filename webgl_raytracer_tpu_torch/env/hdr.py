"""Radiance .hdr (RGBE) decode/encode, host numpy.

The port's own copy of webgl_raytracer_tpu/env/hdr.py: header parse,
adaptive-RLE scanlines, RGBE -> float with scale 2^(e-136), and the
matching RLE encoder.
"""

from __future__ import annotations

import re

import numpy as np


def decode_hdr(data: bytes) -> tuple[int, int, np.ndarray]:
    """Returns (width, height, f32[H,W,4]) — RGB + alpha=1."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("Unsupported HDR header.")

    # Header: lines until blank, then the resolution line.
    pos = 0

    def read_line():
        nonlocal pos
        end = data.find(b"\n", pos)
        if end < 0:
            raise ValueError("Unexpected end of HDR header.")
        line = data[pos:end]
        pos = end + 1
        return line

    read_line()  # magic
    while True:
        line = read_line()
        if line.strip() == b"":
            break
    m = re.match(rb"-Y\s+(\d+)\s+\+X\s+(\d+)", read_line())
    if not m:
        raise ValueError("Failed to parse HDR resolution.")
    height = int(m.group(1))
    width = int(m.group(2))

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(height):
        if pos + 4 > len(data):
            raise ValueError("Unexpected end of HDR data.")
        if buf[pos] != 2 or buf[pos + 1] != 2:
            raise ValueError("Unsupported HDR encoding (non-RLE).")
        if ((int(buf[pos + 2]) << 8) | int(buf[pos + 3])) != width:
            raise ValueError("HDR scanline width mismatch.")
        pos += 4
        for c in range(4):
            x = 0
            while x < width:
                if pos >= len(data):
                    raise ValueError("Unexpected end of HDR data.")
                count = int(buf[pos]); pos += 1
                if count > 128:
                    run = count - 128
                    rgbe[y, x:x + run, c] = buf[pos]
                    pos += 1
                    x += run
                else:
                    rgbe[y, x:x + count, c] = buf[pos:pos + count]
                    pos += count
                    x += count

    out = np.zeros((height, width, 4), np.float32)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.exp2(e - 136).astype(np.float64)).astype(np.float32)
    out[..., :3] = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[..., 3] = 1.0
    return width, height, out


def load_hdr(path: str, logger=None):
    """Load a .hdr file -> dict(width, height, data f32[H,W,4])."""
    with open(path, "rb") as f:
        width, height, data = decode_hdr(f.read())
    if logger:
        logger.info(f"Environment map size {width}x{height}")
    return {"width": width, "height": height, "data": data}


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """f32[...,3] -> u8[...,4] RGBE."""
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    exp = np.zeros_like(maxc, np.int32)
    mant = np.zeros_like(maxc)
    m, e = np.frexp(np.where(nz, maxc, 1.0))
    exp = np.where(nz, e, 0)
    mant = np.where(nz, m, 0.0)
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    out[..., 0] = np.clip(rgb[..., 0] * scale + 0.5, 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(rgb[..., 1] * scale + 0.5, 0, 255).astype(np.uint8)
    out[..., 2] = np.clip(rgb[..., 2] * scale + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def encode_hdr(rgb: np.ndarray) -> bytes:
    """f32[H,W,3] -> Radiance RLE .hdr bytes."""
    h, w = rgb.shape[:2]
    rgbe = _float_to_rgbe(np.asarray(rgb, np.float32))
    parts = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
             f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        parts.append(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            enc = bytearray()
            while x < w:
                # Find a run of equal bytes.
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 4:
                    enc.append(128 + run)
                    enc.append(int(row[x]))
                    x += run
                else:
                    # Literal segment until next run of >= 4.
                    start = x
                    while x < w and x - start < 128:
                        run = 1
                        while x + run < w and run < 4 and row[x + run] == row[x]:
                            run += 1
                        if run >= 4:
                            break
                        x += 1
                    enc.append(x - start)
                    enc.extend(row[start:x].tobytes())
            parts.append(bytes(enc))
    return b"".join(parts)

