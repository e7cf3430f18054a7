"""Pure-Python LZ4 frame/block codec (decompression + a simple compressor).

A copy of rvio_tpu/dataio/lz4.py (numpy and the standard library only).

rosbag's lz4 chunk compression (roslz4) writes the standard LZ4 frame
format; real EuRoC bags in the wild use it (``rosbag compress --lz4``).
The ``lz4`` binding is not available in this environment, so chunks are
decoded here in pure Python:

- Frame format: magic 0x184D2204, FLG/BD descriptor, data blocks
  (4-byte LE size, high bit = stored/uncompressed), EndMark, optional
  checksums (skipped, xxhash verification is not implemented).
- Legacy frame: magic 0x184C2102, raw 8 MiB blocks.
- Block format: token (literal-run len | match len nibbles), extension
  bytes of 255, literals, 2-byte LE match offset, overlap-allowed copy.

Throughput is obviously far below the C codec (~10 MB/s); fine for
dataset replay where decode overlaps the device-side filter, and the
only alternative in a hermetic environment is failing the read.

The compressor is a greedy hash-table matcher producing valid (not
maximally compact) blocks; it exists so tests can round-trip real
compressed data without external tooling.
"""

from __future__ import annotations

import struct

FRAME_MAGIC = 0x184D2204
LEGACY_MAGIC = 0x184C2102
_MIN_MATCH = 4


def decompress_block(src: bytes, max_size: int | None = None) -> bytes:
    """Decode one raw LZ4 block (no framing)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        # literal run
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # last sequence: literals only
        # match
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("lz4: invalid zero offset")
        mlen = (token & 0xF) + _MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("lz4: offset beyond output start")
        if offset >= mlen:
            out += out[start:start + mlen]
        else:  # overlapping copy (run-length style), byte semantics
            for k in range(mlen):
                out.append(out[start + k])
        if max_size is not None and len(out) > max_size:
            raise ValueError("lz4: block exceeds declared size")
    return bytes(out)


def decompress_frame(data: bytes) -> bytes:
    """Decode an LZ4 frame (standard or legacy) to bytes."""
    if len(data) < 4:
        raise ValueError("lz4: truncated frame")
    magic = struct.unpack_from("<I", data, 0)[0]
    i = 4
    out = bytearray()

    if magic == LEGACY_MAGIC:
        while i + 4 <= len(data):
            bsize = struct.unpack_from("<I", data, i)[0]
            if bsize in (FRAME_MAGIC, LEGACY_MAGIC):
                break  # concatenated next frame
            i += 4
            out += decompress_block(data[i:i + bsize])
            i += bsize
        return bytes(out)

    if magic != FRAME_MAGIC:
        raise ValueError(f"lz4: bad magic 0x{magic:08x}")

    flg = data[i]
    i += 1
    version = flg >> 6
    if version != 1:
        raise ValueError(f"lz4: unsupported frame version {version}")
    block_checksum = bool(flg & 0x10)
    content_size = bool(flg & 0x08)
    dict_id = bool(flg & 0x01)
    i += 1  # BD byte (max block size — irrelevant for decode)
    if content_size:
        i += 8
    if dict_id:
        i += 4
    i += 1  # HC header checksum (not verified)

    while True:
        if i + 4 > len(data):
            raise ValueError("lz4: truncated block header")
        bsize = struct.unpack_from("<I", data, i)[0]
        i += 4
        if bsize == 0:  # EndMark
            break
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = data[i:i + bsize]
        if len(block) < bsize:
            raise ValueError("lz4: truncated block")
        i += bsize
        if block_checksum:
            i += 4
        out += block if stored else decompress_block(block)
    return bytes(out)


def _xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (needed for header checksums when writing frames)."""
    P1, P2, P3, P4, P5 = (2654435761, 2246822519, 3266489917,
                          668265263, 374761393)
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i <= n - 16:
            for _v in range(4):
                lane = struct.unpack_from("<I", data, i)[0]
                if _v == 0:
                    v1 = (rotl((v1 + lane * P2) & M, 13) * P1) & M
                elif _v == 1:
                    v2 = (rotl((v2 + lane * P2) & M, 13) * P1) & M
                elif _v == 2:
                    v3 = (rotl((v3 + lane * P2) & M, 13) * P1) & M
                else:
                    v4 = (rotl((v4 + lane * P2) & M, 13) * P1) & M
                i += 4
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i <= n - 4:
        h = (rotl((h + struct.unpack_from("<I", data, i)[0] * P3) & M, 17)
             * P4) & M
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def compress_block(src: bytes) -> bytes:
    """Greedy single-pass LZ4 block compressor (valid, not optimal)."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return b"\x00"

    def emit(lit_start: int, lit_len: int, mlen: int, offset: int) -> None:
        nonlocal out
        lt = min(lit_len, 15)
        mt = min(mlen - _MIN_MATCH, 15) if mlen else 0
        out.append((lt << 4) | mt)
        rem = lit_len - 15
        while rem >= 0:
            out.append(min(rem, 255))
            if rem < 255:
                break
            rem -= 255
        out += src[lit_start:lit_start + lit_len]
        if mlen:
            out += struct.pack("<H", offset)
            rem = mlen - _MIN_MATCH - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255

    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    # spec: last match must start >=12 bytes from end; last 5 bytes literal
    limit = n - 12
    while i < limit:
        key = src[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 65535 and src[cand:cand + 4] == key:
            mlen = 4
            maxm = n - 5 - i
            while mlen < maxm and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            emit(anchor, i - anchor, mlen, i - cand)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(anchor, n - anchor, 0, 0)
    return bytes(out)


_MAX_BLOCK = 4 << 20  # BD byte 0x70 declares a 4 MiB max block size


def compress_frame(data: bytes) -> bytes:
    """Produce a standard LZ4 frame (content-size flag, <=4 MiB blocks).

    Payloads larger than the declared max block size are split into
    multiple blocks so the frame stays spec-conformant — the C
    ``lz4.frame`` binding (the reader's preferred fast path) and external
    tools reject frames whose blocks exceed the BD-declared size.
    """
    flg = (1 << 6) | 0x08  # version 1, content size present
    bd = 0x70
    desc = bytes([flg, bd]) + struct.pack("<Q", len(data))
    hc = (_xxh32(desc) >> 8) & 0xFF
    body = b""
    for off in range(0, max(len(data), 1), _MAX_BLOCK):
        chunk = data[off:off + _MAX_BLOCK]
        block = compress_block(chunk)
        if len(block) >= len(chunk) and len(chunk) > 0:
            body += struct.pack("<I", 0x80000000 | len(chunk)) + chunk
        else:
            body += struct.pack("<I", len(block)) + block
    return (struct.pack("<I", FRAME_MAGIC) + desc + bytes([hc])
            + body + struct.pack("<I", 0))
