"""The port's copies of the replay inputs against the JAX package's modules:
the same inputs give the same bytes and arrays.

- ``png``: the writer's bytes, PNGs the JAX package wrote, a filtered PNG;
- ``lz4``: frames, blocks and xxh32 on the payloads of tests/test_lz4.py;
- ``rosbag``: the writer's bytes and ``load_rosbag``'s arrays for
  uncompressed, bz2 and lz4 chunks, drop counts, out-of-order messages,
  truncated bags, ground-truth topics, ``bag_info`` and ``iter_messages``;
- ``euroc``: ``load_euroc`` of an ASL folder, with and without a skip;
- ``native_loader``: the port's build of native/dataloader.cpp decodes as
  the python codec does (skips where g++ is missing);
- the trajectory SVG and the ``eval`` CLI.
"""

import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from rvio_tpu.dataio import euroc as jeuroc
from rvio_tpu.dataio import lz4 as jlz4
from rvio_tpu.dataio import png as jpng
from rvio_tpu.dataio import rosbag as jrosbag
from rvio_tpu_torch.dataio import euroc, lz4, png, rosbag

torch.set_num_threads(1)


def _same(a, b):
    """Dataclass instances (or plain values) equal field by field."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for k in a.__dataclass_fields__:
            _same(getattr(a, k), getattr(b, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


# ---- png ----

@pytest.mark.parametrize("shape", [(1, 1), (8, 16), (120, 160)])
def test_png_matches_reference(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    png.write_png_gray(str(tmp_path / "port.png"), img)
    jpng.write_png_gray(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(png.read_png_gray(str(tmp_path / "jax.png")),
                                  img)


def test_png_reads_filtered_rows(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(8, 16), dtype=np.uint8)
    raw, prev = b"", np.zeros(16, np.int32)
    for y in range(8):                       # filter 2 (Up) on every row
        raw += b"\x02" + ((img[y].astype(np.int32) - prev) % 256
                          ).astype(np.uint8).tobytes()
        prev = img[y].astype(np.int32)

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 8, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png_gray(p), jpng.read_png_gray(p))
    np.testing.assert_array_equal(png.read_png_gray(p), img)


# ---- lz4 ----

def _payloads():
    rng = np.random.default_rng(42)
    return {
        "empty": b"", "short": b"abc",
        "no_match": bytes(rng.integers(0, 256, 64, dtype=np.uint8)),
        "runs": b"\x00" * 1000 + b"ab" * 500 + b"\xff" * 77,
        "binary": bytes(rng.integers(0, 8, 100_000, dtype=np.uint8)),
        "overlap": b"a" * 3 + b"abcabcabc" * 50,
    }


@pytest.mark.parametrize("name", list(_payloads()))
def test_lz4_matches_reference(name):
    data = _payloads()[name]
    frame = lz4.compress_frame(data)
    assert frame == jlz4.compress_frame(data)
    assert lz4.compress_block(data) == jlz4.compress_block(data)
    assert lz4.decompress_frame(jlz4.compress_frame(data)) == data
    assert lz4._xxh32(data) == jlz4._xxh32(data)


# ---- rosbag ----

def _messages(n_imu=40, n_img=5, h=24, w=32, t0=100.0, seed=0):
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n_imu):
        t = t0 + i / 200.0
        msgs.append(("/imu0", b"sensor_msgs/Imu", t, rosbag.serialize_imu(
            i, t, rng.normal(size=3), rng.normal(size=3) + [0, 0, 9.81])))
    for k in range(n_img):
        t = t0 + k / 20.0
        msgs.append(("/cam0/image_raw", b"sensor_msgs/Image", t,
                     rosbag.serialize_image(k, t, rng.integers(
                         0, 256, size=(h, w), dtype=np.uint8))))
    for i in range(20):
        t = t0 + i * 0.05
        msgs.append(("/vicon/firefly_sbx/firefly_sbx",
                     b"geometry_msgs/TransformStamped", t,
                     rosbag.serialize_transform_stamped(
                         i, t, rng.normal(size=3), rng.normal(size=4),
                         b"firefly_sbx")))
    msgs.sort(key=lambda m: m[2])
    return msgs


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_rosbag_matches_reference(tmp_path, compression):
    msgs = _messages()
    port, ref = str(tmp_path / "port.bag"), str(tmp_path / "jax.bag")
    rosbag.write_rosbag(port, msgs, compression=compression, chunk_count=3)
    jrosbag.write_rosbag(ref, msgs, compression=compression, chunk_count=3)
    assert open(port, "rb").read() == open(ref, "rb").read()
    _same(rosbag.bag_info(ref), jrosbag.bag_info(ref))
    for kw in ({}, {"skip_s": 0.05}, {"max_frames": 3}, {"gt_topic": None}):
        _same(rosbag.load_rosbag(ref, **kw), jrosbag.load_rosbag(ref, **kw))
    _same(list(rosbag.iter_messages(ref)), list(jrosbag.iter_messages(ref)))


def test_rosbag_drops_and_order_match_reference(tmp_path):
    msgs = _messages(n_imu=12, n_img=4)
    kept = [m for m in msgs if not (
        (m[0] == "/imu0" and int.from_bytes(m[3][:4], "little") in (3, 4))
        or (m[0] == "/cam0/image_raw"
            and int.from_bytes(m[3][:4], "little") == 2))]
    p = str(tmp_path / "gaps.bag")
    jrosbag.write_rosbag(p, kept)
    seq = rosbag.load_rosbag(p)
    assert (seq.imu_drops, seq.image_drops) == (2, 1)
    _same(seq, jrosbag.load_rosbag(p))
    imu = [i for i, m in enumerate(msgs) if m[0] == "/imu0"]
    img = [i for i, m in enumerate(msgs) if m[0] == "/cam0/image_raw"]
    msgs[imu[1]], msgs[imu[2]] = msgs[imu[2]], msgs[imu[1]]
    msgs[img[0]], msgs[img[2]] = msgs[img[2]], msgs[img[0]]
    p = str(tmp_path / "unsorted.bag")
    jrosbag.write_rosbag(p, msgs)
    seq = rosbag.load_rosbag(p)
    assert np.all(np.diff(seq.imu_t) >= 0) and np.all(np.diff(seq.cam_t) > 0)
    _same(seq, jrosbag.load_rosbag(p))


@pytest.mark.parametrize("compression,frac", [("none", 0.35), ("none", 0.97),
                                              ("bz2", 0.85)])
def test_truncated_rosbag_matches_reference(tmp_path, compression, frac):
    msgs = _messages(n_imu=400, n_img=40)
    p = str(tmp_path / "full.bag")
    jrosbag.write_rosbag(p, msgs, compression=compression, chunk_count=8)
    blob = open(p, "rb").read()
    cut = str(tmp_path / "cut.bag")
    with open(cut, "wb") as f:
        f.write(blob[:int(len(blob) * frac)])
    seq = rosbag.load_rosbag(cut)
    assert 2 <= len(seq.imu_t) < 400 and 1 <= len(seq.cam_t) <= 40
    _same(seq, jrosbag.load_rosbag(cut))


# ---- euroc ----

def test_euroc_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    mav = tmp_path / "mav0"
    for d in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        (mav / d).mkdir(parents=True)
    t0 = 1_400_000_000_000_000_000
    imu = [(t0 + i * 5_000_000, *rng.normal(size=6)) for i in range(200)]
    (mav / "imu0" / "data.csv").write_text(
        "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n"
        + "".join(",".join(str(v) for v in r) + "\n" for r in imu))
    cams = [t0 + k * 50_000_000 for k in range(20)]
    (mav / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n" + "".join(f"{t},{t}.png\n" for t in cams))
    gt = [(t0 + i * 10_000_000, *rng.normal(size=7)) for i in range(100)]
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp,px,py,pz,qw,qx,qy,qz\n"
        + "".join(",".join(str(v) for v in r) + "\n" for r in gt))
    for skip in (0.0, 0.3):
        _same(euroc.load_euroc(str(tmp_path), skip_s=skip),
              jeuroc.load_euroc(str(tmp_path), skip_s=skip))


# ---- native loader ----

@pytest.fixture
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    from rvio_tpu_torch.dataio import native_loader
    return native_loader


def test_native_loader_matches_python_codec(native, tmp_path):
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, size=(32, 48), dtype=np.uint8)
            for _ in range(6)]
    paths = [str(tmp_path / f"{i}.png") for i in range(6)]
    for p, im in zip(paths, imgs):
        jpng.write_png_gray(p, im)
    assert native.get_lib()._name.startswith(native._PKG)
    for p in paths:
        np.testing.assert_array_equal(native.decode_png_gray(p),
                                      png.read_png_gray(p))
        np.testing.assert_array_equal(euroc.load_image(p, native=True),
                                      euroc.load_image(p, native=False))
    loader = native.BatchLoader(n_threads=2)
    try:
        loader.submit(paths, width=48, height=32)
        np.testing.assert_array_equal(loader.collect(), np.stack(imgs))
    finally:
        loader.close()


# ---- outputs ----

def test_trajectory_svg_and_eval_cli_match_reference(tmp_path, capsys):
    from rvio_tpu.eval.__main__ import main as jax_eval
    from rvio_tpu.utils.visualize import plot_trajectory_svg as jax_svg
    from rvio_tpu_torch.dataio.tum import write_tum
    from rvio_tpu_torch.eval.__main__ import main as port_eval
    from rvio_tpu_torch.utils import plot_trajectory_svg
    rng = np.random.default_rng(4)
    t = np.arange(50) * 0.05
    gt = np.cumsum(rng.normal(size=(50, 3)) * 0.01, axis=0)
    est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + 1.0
    lms = rng.normal(size=(30, 3))
    plot_trajectory_svg(str(tmp_path / "port.svg"), est, gt_p=gt,
                        landmarks=lms, landmark_scale=0.05)
    jax_svg(str(tmp_path / "jax.svg"), est, gt_p=gt, landmarks=lms,
            landmark_scale=0.05)
    assert (tmp_path / "port.svg").read_text() == \
        (tmp_path / "jax.svg").read_text()
    q = np.tile([0.0, 0.0, 0.0, 1.0], (50, 1))
    write_tum(str(tmp_path / "gt.tum"), t, gt, q)
    write_tum(str(tmp_path / "est.tum"), t, est, q)
    argv = [str(tmp_path / "est.tum"), str(tmp_path / "gt.tum")]
    assert port_eval(argv) == 0
    port_out = capsys.readouterr().out
    assert jax_eval(argv) == 0
    assert port_out == capsys.readouterr().out
    assert "ATE RMSE: 0.0000 m" in port_out
