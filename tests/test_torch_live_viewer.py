"""The port's live viewer (rvio_tpu_torch/utils/live_viewer.py) on
127.0.0.1, port 0: tests/test_live_viewer.py's case, and the SVG it
serves byte-equal to the JAX package's viewer on the same poses."""

import urllib.error
import urllib.request

import numpy as np
import torch

from rvio_tpu.utils.live_viewer import LiveViewer as JaxViewer
from rvio_tpu_torch.utils.live_viewer import LiveViewer

torch.set_num_threads(1)


def _get(v, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}",
                                  timeout=5).read()


def test_viewer_serves_page_and_svg():
    poses = [(0.0, np.array([0.0, 0.0, 0.0]), np.array([0, 0, 0, 1.0]))]
    v = LiveViewer(lambda: poses, port=0).start()
    try:
        page = _get(v, "/")
        assert b"rvio_tpu live" in page
        # empty-ish trajectory still serves valid SVG
        assert _get(v, "/traj.svg").startswith(b"<svg")
        # grow the trajectory; the served SVG tracks it
        for k in range(1, 50):
            poses.append((k * 0.05, np.array([0.1 * k, 0.05 * k, 0.0]),
                          np.array([0, 0, 0, 1.0])))
        assert b"polyline" in _get(v, "/traj.svg")
        assert b"poses: 50" in _get(v, "/meta")
    finally:
        v.stop()


def test_viewer_matches_jax():
    """Every path of both viewers on the same poses and landmarks (a pose
    list and an array source) gives the same bytes; 404 alike."""
    rng = np.random.default_rng(2)
    poses = [(0.05 * k, rng.normal(size=3), np.array([0, 0, 0, 1.0]))
             for k in range(30)]
    lms = rng.uniform(-3, 3, (40, 3))
    for source in (lambda: poses,
                   lambda: np.stack([p for _, p, _ in poses])):
        ours = LiveViewer(source, port=0, landmarks_source=lambda: lms,
                          axes=(0, 2)).start()
        ref = JaxViewer(source, port=0, landmarks_source=lambda: lms,
                        axes=(0, 2)).start()
        try:
            for path in ("/", "/traj.svg", "/meta"):
                assert _get(ours, path) == _get(ref, path), path
            for v in (ours, ref):
                try:
                    _get(v, "/missing")
                    raise AssertionError("no 404")
                except urllib.error.HTTPError as e:
                    assert e.code == 404
        finally:
            ours.stop()
            ref.stop()
