"""Online (streaming) driver: live sensor feeds -> poses.

Port of rvio_tpu/runtime/online.py.  Wires the thread-safe InputBuffer to
the image pipeline -- the equivalent of the reference node's callback loop
(reference: src/rvio_mono.cc:54-87 -> System::MonoVIO), for live camera/IMU
feeds instead of offline replay:

- producers call :meth:`push_imu` / :meth:`push_image` from any thread
  (sensor callbacks), optionally with a message sequence number;
- sequence-number gaps are detected and counted per stream, matching the
  reference's drop logging (rvio_mono.cc:56-59 image, :84-87 imu);
- a consumer calls :meth:`spin_once` (or :meth:`spin`) to pop the next
  time-aligned (image, imu-block) pair and advance the filter.

The driver runs on the CUDA device unless asked for the CPU.  An image's
copy to the device is enqueued when it is pushed, so it overlaps the wait
for IMU coverage; each processed frame reads back one packed vector.
Offline replay should use the chunked driver (runtime/image_driver.py);
this path pays one dispatch per frame, the shape of a 20 Hz live feed
where latency, not throughput, matters.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.runtime.image_driver import ImagePipeline
from rvio_tpu_torch.runtime.input_buffer import InputBuffer

log = logging.getLogger("rvio_tpu_torch.online")


class OnlineDriver:
    """Streaming pipeline driver with drop detection.

    Thread model matches the reference: producer threads push into the
    mutex-guarded buffer; one consumer thread spins the filter.
    """

    def __init__(self, cfg: RVIOConfig, dtype=torch.float32, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.buffer = InputBuffer()
        self.pipeline = ImagePipeline(cfg, dtype=dtype, seed=seed,
                                      device=device)
        self.drops = {"imu": 0, "image": 0}
        self._last_seq = {"imu": None, "image": None}
        self._seq_lock = threading.Lock()
        self.poses = []          # (t, p_Gk, q_kG) appended per processed frame
        self._pending = None     # in-flight frame of the pipelined spin

    def _check_seq(self, stream: str, seq: Optional[int]) -> None:
        if seq is None:
            return
        with self._seq_lock:
            last = self._last_seq[stream]
            if last is not None and seq > last + 1:
                # same semantics as the reference's seq-gap warning
                # (rvio_mono.cc:56-59, 84-87)
                self.drops[stream] += seq - last - 1
                log.warning("%s message drop: seq %d -> %d", stream, last, seq)
            self._last_seq[stream] = seq

    def push_imu(self, t: float, w, a, seq: Optional[int] = None) -> None:
        self._check_seq("imu", seq)
        self.buffer.push_imu(t, w, a)

    def push_image(self, t: float, image, seq: Optional[int] = None) -> None:
        self._check_seq("image", seq)
        # enqueue the copy to the device at push time: it then overlaps
        # whatever wait for IMU coverage precedes processing
        self.buffer.push_image(t, self.pipeline.upload_image(image))

    def spin_once(self) -> Optional[dict]:
        """Process the next ready frame; returns its outputs or None.

        None means either no frame is ready (buffer waiting for IMU
        coverage) or the frame was consumed pre-initialization.

        Core fields (pose, velocity, counters) arrive via ONE packed
        device->host copy; the per-feature diagnostics (landmarks etc.) are
        available through ``pipeline.process`` directly when needed.
        """
        # resolve any frame left in flight by spin_once_pipelined FIRST so
        # self.poses stays chronological when callers mix the two modes
        # (the pipelined frame is always older than the next ready frame)
        if self._pending is not None:
            self.drain()
        m = self.buffer.get_measurements(self.cfg.camera.time_offset)
        if m is None:
            return None
        t_img, image, w, a, dt = m
        out = self.pipeline.process_packed(t_img, image, w, a, dt)
        if out is not None:
            self.poses.append((t_img, out["p_Gk"], out["q_kG"]))
            return {"t": t_img, **out}
        return None

    def spin_once_pipelined(self) -> Optional[dict]:
        """One-frame-deep pipelined spin: dispatch the next ready frame,
        return the PREVIOUS frame's outputs (one frame of output lag).

        The previous frame's vector is read after this frame's work is
        enqueued (on the same stream, so the read also waits for this
        frame's kernels), so the device runs the previous frame while the
        host dispatches this one.  Use when frames queue faster than
        single-frame latency (backlog / replay-through-live-path); call
        :meth:`drain` at end of stream.
        """
        m = self.buffer.get_measurements(self.cfg.camera.time_offset)
        dispatched = None
        if m is not None:
            t_img, image, w, a, dt = m
            dev = self.pipeline.process_device(t_img, image, w, a, dt)
            if dev is not None:
                dispatched = (t_img, dev)
        prev = self._pending
        self._pending = dispatched
        if prev is None:
            return None
        t_prev, dev_prev = prev
        out = self.pipeline.unpack(dev_prev)
        self.poses.append((t_prev, out["p_Gk"], out["q_kG"]))
        return {"t": t_prev, **out}

    def drain(self) -> Optional[dict]:
        """Resolve and return the last in-flight pipelined frame, if any."""
        prev = self._pending
        self._pending = None
        if prev is None:
            return None
        t_prev, dev_prev = prev
        out = self.pipeline.unpack(dev_prev)
        self.poses.append((t_prev, out["p_Gk"], out["q_kG"]))
        return {"t": t_prev, **out}

    def spin(self, stop_event: Optional[threading.Event] = None,
             idle_wait_s: float = 0.002) -> None:
        """Consume until ``stop_event`` is set and the buffer drains."""
        import time as _time
        while True:
            got = self.spin_once()
            if got is None:
                if stop_event is not None and stop_event.is_set() \
                        and len(self.buffer) == 0:
                    return
                _time.sleep(idle_wait_s)
