"""Pure-Python rosbag v2.0 reader (no ROS required).

A copy of rvio_tpu/dataio/rosbag.py (numpy and the standard library only).

The reference consumes EuRoC exclusively through ``rosbag play`` with topic
remapping ``/cam0/image_raw -> /camera/image_raw``, ``/imu0 -> /imu``
(reference: README.md:70-86); its node then deserializes
``sensor_msgs/Image`` and ``sensor_msgs/Imu`` callbacks
(reference: src/rvio_mono.cc:54-107).  This module reads the same ``.bag``
files directly — a user with EuRoC bags on disk does not need ROS, a
conversion step, or the ASL folders.

Implements the documented rosbag v2.0 container format:

    #ROSBAG V2.0\\n
    <record>*            record = u32 hlen | header | u32 dlen | data
    header               fields: u32 flen | name '=' value

Record op codes: 0x03 bag header, 0x05 chunk (compression none|bz2|lz4),
0x07 connection, 0x02 message data, 0x04 index data, 0x06 chunk info.
Messages live inside chunks; the reader scans chunks sequentially (no
index needed) and deserializes the two ROS1 message types the reference
subscribes to.  bz2 chunks decompress via the stdlib; lz4 chunks via the
pure-Python frame/block codec in :mod:`rvio_tpu_torch.dataio.lz4` (the C
binding is used instead when importable), so all three rosbag chunk
compressions replay with no external tooling.

A minimal writer is included so the test suite can round-trip synthetic
bags without any ROS tooling.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07


# ---------------------------------------------------------------------------
# low-level record plumbing
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    off = 0
    n = len(buf)
    while off < n:
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        fld = buf[off:off + flen]
        off += flen
        eq = fld.index(b"=")
        fields[fld[:eq]] = fld[eq + 1:]
    return fields


def _iter_records(buf: bytes, off: int = 0,
                  tolerate_truncation: bool = False
                  ) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    """Iterate length-prefixed records.

    ``tolerate_truncation``: a record cut mid-write (recorder crash /
    partial copy — rosbag's own reindex handles these) ends iteration
    cleanly instead of raising; every complete record before the cut is
    still yielded.
    """
    n = len(buf)
    while off < n:
        if tolerate_truncation and off + 4 > n:
            return
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if tolerate_truncation and off + hlen + 4 > n:
            return
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if tolerate_truncation and off + dlen > n:
            return
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _u32(b: bytes) -> int:
    return struct.unpack("<I", b)[0]


def _time(b: bytes) -> float:
    sec, nsec = struct.unpack("<II", b)
    return sec + nsec * 1e-9


# ---------------------------------------------------------------------------
# ROS1 message deserialization (only what the reference subscribes to)
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n: int = 1) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f8", count=n, offset=self.off)
        self.off += 8 * n
        return v

    def string(self) -> bytes:
        n = self.u32()
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def bytes_(self, n: int) -> bytes:
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def ros_header(self) -> Tuple[int, float]:
        """std_msgs/Header: seq, stamp, frame_id."""
        seq = self.u32()
        sec = self.u32()
        nsec = self.u32()
        self.string()  # frame_id
        return seq, sec + nsec * 1e-9


@dataclass
class ImuMsg:
    seq: int
    stamp: float
    w: np.ndarray  # (3,) rad/s
    a: np.ndarray  # (3,) m/s^2


@dataclass
class ImageMsg:
    seq: int
    stamp: float
    encoding: str
    image: np.ndarray  # (H,W) uint8 for mono8; (H,W,3) for rgb8/bgr8


def parse_imu(data: bytes) -> ImuMsg:
    """sensor_msgs/Imu — the fields rvio_mono.cc:90-100 reads."""
    c = _Cursor(data)
    seq, stamp = c.ros_header()
    c.f64(4)   # orientation quaternion (unused by the reference)
    c.f64(9)   # orientation covariance
    w = c.f64(3).copy()
    c.f64(9)
    a = c.f64(3).copy()
    c.f64(9)
    return ImuMsg(seq=seq, stamp=stamp, w=w, a=a)


@dataclass
class PoseMsg:
    seq: int
    stamp: float
    p: np.ndarray                    # (3,)
    q: Optional[np.ndarray] = None   # (4,) xyzw, None for position-only


def parse_point_stamped(data: bytes) -> PoseMsg:
    """geometry_msgs/PointStamped (EuRoC /leica/position ground truth)."""
    c = _Cursor(data)
    seq, stamp = c.ros_header()
    return PoseMsg(seq=seq, stamp=stamp, p=c.f64(3).copy())


def parse_transform_stamped(data: bytes) -> PoseMsg:
    """geometry_msgs/TransformStamped (EuRoC /vicon/... ground truth)."""
    c = _Cursor(data)
    seq, stamp = c.ros_header()
    c.string()  # child_frame_id
    p = c.f64(3).copy()
    q = c.f64(4).copy()
    return PoseMsg(seq=seq, stamp=stamp, p=p, q=q)


_GT_PARSERS = {
    b"geometry_msgs/PointStamped": parse_point_stamped,
    b"geometry_msgs/TransformStamped": parse_transform_stamped,
}


def parse_image(data: bytes) -> ImageMsg:
    """sensor_msgs/Image — decoded like cv_bridge MONO8 (rvio_mono.cc:61-74)."""
    c = _Cursor(data)
    seq, stamp = c.ros_header()
    height = c.u32()
    width = c.u32()
    encoding = c.string().decode()
    c.u8()           # is_bigendian
    step = c.u32()
    n = c.u32()
    raw = np.frombuffer(c.bytes_(n), np.uint8)
    if encoding == "mono8":
        img = raw.reshape(height, step)[:, :width]
    elif encoding in ("rgb8", "bgr8"):
        img = raw.reshape(height, step)[:, :width * 3].reshape(height, width, 3)
        if encoding == "bgr8":
            img = img[..., ::-1]
    elif encoding == "mono16":
        img16 = raw.view("<u2").reshape(height, step // 2)[:, :width]
        img = (img16 >> 8).astype(np.uint8)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return ImageMsg(seq=seq, stamp=stamp, encoding=encoding, image=img)


# ---------------------------------------------------------------------------
# bag reading
# ---------------------------------------------------------------------------

@dataclass
class BagInfo:
    topics: Dict[str, str]          # topic -> type
    message_counts: Dict[str, int]  # topic -> count
    start: Optional[float] = None
    end: Optional[float] = None


def _decompress(header: Dict[bytes, bytes], data: bytes) -> bytes:
    comp = header.get(b"compression", b"none")
    if comp == b"none":
        return data
    if comp == b"bz2":
        return bz2.decompress(data)
    if comp == b"lz4":
        try:  # the C binding when present (fast path; not baked in here)
            import lz4.frame as _lz4c  # type: ignore
            return _lz4c.decompress(data)
        except ImportError:
            from rvio_tpu_torch.dataio.lz4 import decompress_frame
            return decompress_frame(data)
    raise ValueError(f"unknown chunk compression {comp!r}")


def _scan(path: str):
    """Yield (connections, conn_id, time, msgdata) over all chunks.

    The bag is memory-mapped, so only the chunk being decoded is resident —
    EuRoC bags are 1-3 GB.
    """
    import mmap

    f = open(path, "rb")
    try:
        blob = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError:  # empty file
        f.close()
        raise ValueError(f"{path}: not a rosbag v2.0 file")
    if blob[:len(_MAGIC)] != _MAGIC:
        blob.close()
        f.close()
        raise ValueError(f"{path}: not a rosbag v2.0 file")
    try:
        yield from _scan_records(blob)
    finally:
        blob.close()
        f.close()


def _scan_records(blob):
    connections: Dict[int, Dict[bytes, bytes]] = {}
    for header, data in _iter_records(blob, len(_MAGIC),
                                      tolerate_truncation=True):
        op = header[b"op"][0]
        if op == OP_CONN:
            connections[_u32(header[b"conn"])] = _parse_header(data)
        elif op == OP_CHUNK:
            try:
                body = _decompress(header, data)
            except (OSError, ValueError):
                # a truncated final chunk: its compressed stream is cut —
                # stop at the last complete chunk (rosbag reindex behavior)
                return
            for ch, cd in _iter_records(body):
                cop = ch[b"op"][0]
                if cop == OP_CONN:
                    connections[_u32(ch[b"conn"])] = _parse_header(cd)
                elif cop == OP_MSG:
                    yield (connections, _u32(ch[b"conn"]),
                           _time(ch[b"time"]), cd)
        elif op == OP_MSG:  # unchunked (rare, writer-crash bags)
            yield connections, _u32(header[b"conn"]), _time(header[b"time"]), data


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img
    return (img.astype(np.float32)
            @ np.asarray([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)


def bag_info(path: str) -> BagInfo:
    """Topic inventory of a bag (like ``rosbag info``)."""
    info = BagInfo(topics={}, message_counts={})
    for conns, cid, t, _ in _scan(path):
        c = conns[cid]
        topic = c[b"topic"].decode()
        info.topics[topic] = c.get(b"type", b"?").decode()
        info.message_counts[topic] = info.message_counts.get(topic, 0) + 1
        info.start = t if info.start is None else min(info.start, t)
        info.end = t if info.end is None else max(info.end, t)
    return info


@dataclass
class BagSequence:
    """In-memory sensor streams from a bag, EurocSequence-compatible.

    ``images`` replaces the ASL loader's ``cam_files`` — frames are decoded
    straight out of the bag.  Per-sample IMU dt follows the reference's
    convention: dt[0] = 0 handled downstream (rvio_mono.cc:102-107).
    """
    imu_t: np.ndarray
    imu_w: np.ndarray
    imu_a: np.ndarray
    cam_t: np.ndarray
    images: np.ndarray               # (T, H, W) uint8
    cam_files: Optional[list] = None  # None: frames are in memory
    gt_t: Optional[np.ndarray] = None
    gt_p: Optional[np.ndarray] = None
    gt_q: Optional[np.ndarray] = None
    imu_drops: int = 0
    image_drops: int = 0


def load_rosbag(path: str, image_topic: str = "/cam0/image_raw",
                imu_topic: str = "/imu0", skip_s: float = 0.0,
                max_frames: Optional[int] = None,
                gt_topic: Optional[str] = "auto") -> BagSequence:
    """Load one camera topic + one IMU topic from a bag.

    Defaults match the EuRoC bags the reference remaps (README.md:73-86).
    ``skip_s`` drops the first seconds (MH_* sequences need ~40 s).
    Message-sequence gaps are counted the way rvio_mono.cc:56-59,84-87
    logs drops.

    Ground truth: EuRoC bags carry it as geometry_msgs topics
    (/vicon/firefly_sbx/firefly_sbx TransformStamped on V*,
    /leica/position PointStamped on MH*).  ``gt_topic="auto"`` picks the
    first topic with a known ground-truth message type; pass a topic name
    to select explicitly or None to skip.
    """
    imu_t: List[float] = []
    imu_w: List[np.ndarray] = []
    imu_a: List[np.ndarray] = []
    cam_t: List[float] = []
    images: List[np.ndarray] = []
    gt: List[PoseMsg] = []
    gt_sel = [gt_topic]
    drops = [0, 0]
    last_seq = [None, None]  # imu, image

    for conns, cid, _t, data in _scan(path):
        conn = conns[cid]
        topic = conn[b"topic"].decode()
        mtype = conn.get(b"type", b"")
        if gt_sel[0] == "auto" and mtype in _GT_PARSERS:
            gt_sel[0] = topic
        if topic == gt_sel[0] and mtype in _GT_PARSERS:
            gt.append(_GT_PARSERS[mtype](data))
            continue
        if topic == imu_topic:
            m = parse_imu(data)
            if last_seq[0] is not None and m.seq > last_seq[0] + 1:
                drops[0] += m.seq - last_seq[0] - 1
            last_seq[0] = m.seq
            imu_t.append(m.stamp)
            imu_w.append(m.w)
            imu_a.append(m.a)
        elif topic == image_topic:
            if max_frames is not None and len(images) >= max_frames:
                continue
            m = parse_image(data)
            if last_seq[1] is not None and m.seq > last_seq[1] + 1:
                drops[1] += m.seq - last_seq[1] - 1
            last_seq[1] = m.seq
            cam_t.append(m.stamp)
            images.append(_to_gray(m.image))

    if not cam_t:
        raise ValueError(f"{path}: no messages on image topic {image_topic!r}"
                         f" (topics: {sorted(bag_info(path).topics)})")
    if len(imu_t) < 2:
        raise ValueError(f"{path}: no messages on imu topic {imu_topic!r}")

    order = np.argsort(np.asarray(imu_t), kind="stable")
    # Image order must be monotonic too: bundle_imu and the skip/ATE
    # searchsorted calls downstream assume sorted cam_t, and bags can store
    # messages out of receipt order.
    cam_order = np.argsort(np.asarray(cam_t), kind="stable")
    cam_t = [cam_t[i] for i in cam_order]
    images = [images[i] for i in cam_order]
    gt_t = gt_p = gt_q = None
    if gt:
        go = np.argsort([m.stamp for m in gt], kind="stable")
        gt_t = np.asarray([gt[i].stamp for i in go])
        gt_p = np.stack([gt[i].p for i in go])
        if gt[0].q is not None:
            gt_q = np.stack([gt[i].q for i in go])
    seq = BagSequence(
        imu_t=np.asarray(imu_t)[order], imu_w=np.stack(imu_w)[order],
        imu_a=np.stack(imu_a)[order], cam_t=np.asarray(cam_t),
        images=np.stack(images), gt_t=gt_t, gt_p=gt_p, gt_q=gt_q,
        imu_drops=drops[0], image_drops=drops[1])
    if skip_s > 0:
        t0 = seq.cam_t[0] + skip_s
        ci = int(np.searchsorted(seq.cam_t, t0))
        ii = int(np.searchsorted(seq.imu_t, t0))
        gi = int(np.searchsorted(gt_t, t0)) if gt_t is not None else 0
        seq = BagSequence(imu_t=seq.imu_t[ii:], imu_w=seq.imu_w[ii:],
                          imu_a=seq.imu_a[ii:], cam_t=seq.cam_t[ci:],
                          images=seq.images[ci:],
                          gt_t=None if gt_t is None else gt_t[gi:],
                          gt_p=None if gt_p is None else gt_p[gi:],
                          gt_q=None if gt_q is None else gt_q[gi:],
                          imu_drops=seq.imu_drops,
                          image_drops=seq.image_drops)
    return seq


def iter_messages(path: str, image_topic: str = "/cam0/image_raw",
                  imu_topic: str = "/imu0"):
    """Stream ('imu', ImuMsg) / ('image', ImageMsg) pairs in bag order.

    Constant memory: one decoded chunk at a time (mmap-backed).  Use this
    to feed a live consumer instead of materializing the whole sequence.
    """
    for conns, cid, _t, data in _scan(path):
        topic = conns[cid][b"topic"].decode()
        if topic == imu_topic:
            yield "imu", parse_imu(data)
        elif topic == image_topic:
            yield "image", parse_image(data)


def play_rosbag(driver, path: str, image_topic: str = "/cam0/image_raw",
                imu_topic: str = "/imu0", realtime: bool = False,
                rate: float = 1.0) -> int:
    """Feed a bag into an OnlineDriver — the ``rosbag play`` equivalent.

    The reference is driven by ``rosbag play`` publishing into its ROS
    callbacks (reference: README.md:80-86); here messages stream straight
    into :class:`rvio_tpu_torch.runtime.online.OnlineDriver`'s push API (the
    consumer spins in another thread).  ``realtime=True`` paces messages at
    ``rate``× wall-clock like rosbag's clock; the default floods as fast as
    the consumer drains.  Returns the number of image messages pushed.
    """
    import time as _time

    t0 = wall0 = None
    n_images = 0
    for kind, m in iter_messages(path, image_topic, imu_topic):
        if realtime:
            if t0 is None:
                t0, wall0 = m.stamp, _time.perf_counter()
            else:
                lag = (m.stamp - t0) / rate - (_time.perf_counter() - wall0)
                if lag > 0:
                    _time.sleep(lag)
        if kind == "imu":
            driver.push_imu(m.stamp, m.w, m.a, seq=m.seq)
        else:
            driver.push_image(m.stamp, _to_gray(m.image), seq=m.seq)
            n_images += 1
    return n_images


# ---------------------------------------------------------------------------
# minimal writer (for tests / synthetic bags)
# ---------------------------------------------------------------------------

def _field(name: bytes, value: bytes) -> bytes:
    f = name + b"=" + value
    return struct.pack("<I", len(f)) + f


def _record(fields: List[Tuple[bytes, bytes]], data: bytes) -> bytes:
    header = b"".join(_field(k, v) for k, v in fields)
    return (struct.pack("<I", len(header)) + header +
            struct.pack("<I", len(data)) + data)


def _stamp(t: float) -> bytes:
    sec = int(t)
    return struct.pack("<II", sec, int(round((t - sec) * 1e9)))


def _ser_header(seq: int, t: float, frame_id: bytes = b"") -> bytes:
    return (struct.pack("<I", seq) + _stamp(t) +
            struct.pack("<I", len(frame_id)) + frame_id)


def serialize_imu(seq: int, t: float, w, a) -> bytes:
    z4 = np.zeros(4).tobytes()
    z9 = np.zeros(9).tobytes()
    return (_ser_header(seq, t) + z4 + z9 +
            np.asarray(w, "<f8").tobytes() + z9 +
            np.asarray(a, "<f8").tobytes() + z9)


def serialize_point_stamped(seq: int, t: float, p) -> bytes:
    return _ser_header(seq, t) + np.asarray(p, "<f8").tobytes()


def serialize_transform_stamped(seq: int, t: float, p, q,
                                child: bytes = b"") -> bytes:
    return (_ser_header(seq, t) + struct.pack("<I", len(child)) + child +
            np.asarray(p, "<f8").tobytes() + np.asarray(q, "<f8").tobytes())


def serialize_image(seq: int, t: float, img: np.ndarray,
                    encoding: bytes = b"mono8") -> bytes:
    h, w = img.shape[:2]
    step = w * (3 if img.ndim == 3 else 1)
    raw = np.ascontiguousarray(img, np.uint8).tobytes()
    return (_ser_header(seq, t) + struct.pack("<II", h, w) +
            struct.pack("<I", len(encoding)) + encoding + b"\x00" +
            struct.pack("<II", step, len(raw)) + raw)


_CONN_TYPES = {
    b"sensor_msgs/Imu": b"6a62c6daae103f4ff57a132d6f95cec2",
    b"sensor_msgs/Image": b"060021388200f6f0f447d0fcd9c64743",
    b"geometry_msgs/PointStamped": b"c63aecb41bfdfd6b7e1fac37c7cbe7bf",
    b"geometry_msgs/TransformStamped": b"b5764a33bfeb3588febc2682852579b0",
}


def write_rosbag(path: str, messages: List[Tuple[str, bytes, float, bytes]],
                 compression: str = "none", chunk_count: int = 1,
                 indexed: bool = False,
                 chunk_bytes: Optional[int] = None) -> None:
    """Write a valid rosbag v2.0: ``messages`` = [(topic, type, t, bytes)].

    Messages are chunked in ``chunk_count`` pieces (or by ``chunk_bytes``
    of uncompressed body, rosbag record's 768 KiB policy) with the
    requested chunk compression.  Connection records are emitted both
    inside the first chunk and at the tail, as rosbag record does.

    ``indexed=True`` emits the FULL indexed container layout of a real
    recorded bag (what the EuRoC distribution ships and the reference
    replays, README.md:70-86): per-connection INDEX_DATA records (op 0x04,
    ver 1, (time, chunk-local offset) pairs) after every chunk, and a tail
    index section at bag-header ``index_pos`` holding the connection
    records followed by one CHUNK_INFO record (op 0x06, ver 1, chunk_pos,
    start/end time, per-connection counts) per chunk.  Our reader scans
    and ignores the index; the conformance test
    (tests/test_euroc_bag_conformance.py) validates this layout field by
    field so real-bag structure stays covered without the dataset.
    """
    conns: Dict[str, int] = {}
    conn_recs = []
    for topic, mtype, _t, _d in messages:
        if topic not in conns:
            cid = len(conns)
            conns[topic] = cid
            chdr = (_field(b"topic", topic.encode()) +
                    _field(b"type", mtype) +
                    _field(b"md5sum", _CONN_TYPES.get(mtype, b"*")) +
                    _field(b"message_definition", b""))
            conn_recs.append(_record(
                [(b"op", bytes([OP_CONN])),
                 (b"conn", struct.pack("<I", cid)),
                 (b"topic", topic.encode())], chdr))

    # split messages into chunk groups
    if chunk_bytes is not None:
        groups: List[List[Tuple[str, bytes, float, bytes]]] = [[]]
        size = 0
        for m in messages:
            if size > chunk_bytes and groups[-1]:
                groups.append([])
                size = 0
            groups[-1].append(m)
            size += len(m[3]) + 64
    else:
        per = -(-len(messages) // max(chunk_count, 1))
        groups = [messages[c:c + per] for c in range(0, len(messages), per)]

    chunks = []          # serialized chunk records
    chunk_index = []     # per chunk: serialized INDEX_DATA records
    chunk_info = []      # per chunk: (start, end, {conn: count}) for the tail
    for gi, group in enumerate(groups):
        body = b"" if gi else b"".join(conn_recs)
        index: Dict[int, List[Tuple[float, int]]] = {}
        counts: Dict[int, int] = {}
        t_lo, t_hi = None, None
        for topic, _mtype, t, data in group:
            cid = conns[topic]
            index.setdefault(cid, []).append((t, len(body)))
            counts[cid] = counts.get(cid, 0) + 1
            t_lo = t if t_lo is None else min(t_lo, t)
            t_hi = t if t_hi is None else max(t_hi, t)
            body += _record([(b"op", bytes([OP_MSG])),
                             (b"conn", struct.pack("<I", cid)),
                             (b"time", _stamp(t))], data)
        if compression == "bz2":
            payload = bz2.compress(body)
        elif compression == "lz4":
            from rvio_tpu_torch.dataio.lz4 import compress_frame
            payload = compress_frame(bytes(body))
        else:
            payload = body
        chunks.append(_record(
            [(b"op", bytes([OP_CHUNK])),
             (b"compression", compression.encode()),
             (b"size", struct.pack("<I", len(body)))], payload))
        idx_recs = b""
        for cid in sorted(index):
            rows = index[cid]
            idx_recs += _record(
                [(b"op", bytes([OP_INDEX])),
                 (b"ver", struct.pack("<I", 1)),
                 (b"conn", struct.pack("<I", cid)),
                 (b"count", struct.pack("<I", len(rows)))],
                b"".join(_stamp(t) + struct.pack("<I", off)
                         for t, off in rows))
        chunk_index.append(idx_recs)
        chunk_info.append((t_lo or 0.0, t_hi or 0.0, counts))

    with open(path, "wb") as f:
        f.write(_MAGIC)
        # bag header record, padded to 4096 bytes with 0x20 as rosbag does
        # (index_pos back-patched after the chunk section is laid out)
        hdr_pos = f.tell()
        bh = [(b"op", bytes([OP_BAGHDR])),
              (b"index_pos", struct.pack("<Q", 0)),
              (b"conn_count", struct.pack("<I", len(conns))),
              (b"chunk_count", struct.pack("<I", len(chunks)))]

        def bag_header(index_pos: int) -> bytes:
            bh[1] = (b"index_pos", struct.pack("<Q", index_pos))
            hdr = b"".join(_field(k, v) for k, v in bh)
            pad = 4096 - 8 - len(hdr)
            return (struct.pack("<I", len(hdr)) + hdr +
                    struct.pack("<I", pad) + b"\x20" * pad)

        f.write(bag_header(0))
        chunk_pos = []
        for ch, idx in zip(chunks, chunk_index):
            chunk_pos.append(f.tell())
            f.write(ch)
            if indexed:
                f.write(idx)
        index_pos = f.tell()
        for r in conn_recs:
            f.write(r)
        if indexed:
            for pos, (t_lo, t_hi, counts) in zip(chunk_pos, chunk_info):
                f.write(_record(
                    [(b"op", bytes([OP_CHUNKINFO])),
                     (b"ver", struct.pack("<I", 1)),
                     (b"chunk_pos", struct.pack("<Q", pos)),
                     (b"start_time", _stamp(t_lo)),
                     (b"end_time", _stamp(t_hi)),
                     (b"count", struct.pack("<I", len(counts)))],
                    b"".join(struct.pack("<II", cid, n)
                             for cid, n in sorted(counts.items()))))
            f.seek(hdr_pos)
            f.write(bag_header(index_pos))
