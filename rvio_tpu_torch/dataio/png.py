"""Minimal dependency-free PNG codec for 8-bit grayscale images.

A copy of rvio_tpu/dataio/png.py (numpy and the standard library only).

The environment ships no PIL/OpenCV; EuRoC camera frames are 8-bit gray
PNGs, so we implement exactly that subset (plus RGB->gray conversion) with
stdlib zlib.  A C++ decoder (native/dataloader) accelerates the bulk-replay
path; this is the portable fallback and the test reference.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def read_png_gray(path: str) -> np.ndarray:
    """Read a PNG as 8-bit grayscale (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    width = height = None
    bit_depth = color_type = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if bit_depth != 8:
                raise NotImplementedError(f"bit depth {bit_depth}")
            if interlace:
                raise NotImplementedError("interlaced PNG")
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    stride = width * channels
    img = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:       # Sub
            line = _unfilter_sub(line, channels)
        elif ftype == 2:       # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:       # Average
            line = _unfilter_avg(line, prev, channels)
        elif ftype == 4:       # Paeth
            line = _unfilter_paeth(line, prev, channels)
        else:
            raise ValueError(f"bad filter {ftype}")
        img[y] = line
        prev = img[y]
    img = img.reshape(height, width, channels)
    if channels == 1:
        return img[:, :, 0]
    if channels >= 3:
        # ITU-R BT.601 luma (matches cv::cvtColor BGR2GRAY weights)
        rgb = img[:, :, :3].astype(np.float32)
        gray = 0.299 * rgb[:, :, 0] + 0.587 * rgb[:, :, 1] + 0.114 * rgb[:, :, 2]
        return np.clip(gray + 0.5, 0, 255).astype(np.uint8)
    return img[:, :, 0]        # gray+alpha: drop alpha


def _unfilter_sub(line, ch):
    out = line.astype(np.int32)
    for i in range(ch, len(line)):
        out[i] = (out[i] + out[i - ch]) & 0xFF
    return out.astype(np.uint8)


def _unfilter_avg(line, prev, ch):
    out = line.astype(np.int32)
    prev = prev.astype(np.int32)
    for i in range(len(line)):
        left = out[i - ch] if i >= ch else 0
        out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
    return out.astype(np.uint8)


def _unfilter_paeth(line, prev, ch):
    out = line.astype(np.int32)
    prev = prev.astype(np.int32)
    for i in range(len(line)):
        a = out[i - ch] if i >= ch else 0
        b = prev[i]
        c = prev[i - ch] if i >= ch else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 array as a grayscale PNG (filter 0 rows)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        c = struct.pack(">I", len(payload)) + ctype + payload
        return c + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    out = (_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)
