"""Streaming sensor buffer — the reference InputBuffer's online interface.

Thread-safe timestamp-sorted FIFOs pairing each image with all IMU samples
up to the image time (+ offset), requiring >= 2 samples per frame
(reference: src/rvio/InputBuffer.{h,cc}: PushImuData :31, PushImageData :42,
GetMeasurements :53).  Per-sample dt is derived from consecutive timestamps
with dt = 0 for the first sample ever seen (rvio_mono.cc:99-107).

Use for live/online feeds; offline replay uses the vectorized
``runtime.driver.bundle_imu`` instead.

A copy of rvio_tpu/runtime/input_buffer.py (numpy only), so the port
imports nothing of the JAX package; tests/test_torch_online.py holds the
two to the same pops.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass(order=True)
class _Stamped:
    t: float
    payload: object = field(compare=False)


class InputBuffer:
    def __init__(self):
        self._imu: List[_Stamped] = []
        self._img: List[_Stamped] = []
        self._lock = threading.Lock()
        self._last_imu_t: Optional[float] = None

    def push_imu(self, t: float, w, a) -> None:
        dt = 0.0 if self._last_imu_t is None else t - self._last_imu_t
        self._last_imu_t = t
        with self._lock:
            bisect.insort(self._imu, _Stamped(t, (np.asarray(w, np.float64),
                                                  np.asarray(a, np.float64),
                                                  dt)))

    def push_image(self, t: float, image) -> None:
        with self._lock:
            bisect.insort(self._img, _Stamped(t, image))

    def get_measurements(self, time_offset: float = 0.0
                         ) -> Optional[Tuple[float, object, np.ndarray,
                                             np.ndarray, np.ndarray]]:
        """Pop (t_img, image, w (K,3), a (K,3), dt (K,)) or None if not ready.

        Mirrors InputBuffer::GetMeasurements (InputBuffer.cc:53-81): returns
        None until IMU data covers the oldest image; frames that end up with
        < 2 samples stay queued (the reference returns false and retries).
        """
        with self._lock:
            if not self._imu or not self._img:
                return None
            t_img = self._img[0].t
            if self._imu[-1].t < t_img + time_offset:
                return None  # not enough IMU yet
            cut = bisect.bisect_right(
                self._imu, _Stamped(t_img + time_offset, None))
            if cut < 2:
                return None
            img = self._img.pop(0)
            samples = self._imu[:cut]
            del self._imu[:cut]
        w = np.stack([s.payload[0] for s in samples])
        a = np.stack([s.payload[1] for s in samples])
        dt = np.asarray([s.payload[2] for s in samples])
        return img.t, img.payload, w, a, dt

    def __len__(self):
        return len(self._img)
