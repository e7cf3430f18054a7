"""The one-dispatch frame: the per-frame work as replays of CUDA graphs.

The JAX package runs a whole sequence, or a chunk of frames, as one
``lax.scan`` dispatch (rvio_tpu/runtime/step.py make_sequence_scan,
rvio_tpu/runtime/image_driver.py make_image_chunk_scan).  PyTorch runs
eagerly: a frame of the port is some 700 launches on the feature path and
2400 on the image path, each with its own host time.  The port's
counterpart of the scan is a CUDA graph of the frame, captured once and
replayed once a frame.

:class:`FrameScan` runs ``body(carry, frame) -> (carry, outputs)`` over T
stacked frames.  Every tensor a graph touches is a static buffer: the
carry, a table of the frames' inputs (a row a frame), a table of their
outputs and a device-side cursor, the row of the current frame, which the
frame advances itself; so a replay takes no copy from the host.  The carry
is chained inside the graph: the frame ends by copying its new carry into
the carry's buffers.

On a CUDA device:

- the first frame after the buffers are allocated runs eagerly, on the
  stream the graphs are captured on.  It is a real frame, and it settles
  what happens at a first call: K8 allocates its per-stream finish tickets
  (ops/klt_iterate.py ``_ticket``), K5 sets its shared-memory attribute,
  cuBLAS sets up its handle and workspace, cached tables are built
  (filter/update.py ``_gate_tables``);
- then a graph of ``unroll`` frames, and one of a single frame for the
  tail, are captured when first needed, with ``capture_error_mode=
  "global"``: a host sync, a copy from pageable host memory or a library
  call that refuses capture makes the capture raise.  Nothing falls back
  to eager frames;
- every graph of a device shares one memory pool and one stream, on which
  it is captured and replayed: K8's ticket is that of the stream a graph
  was captured on, so graphs that hold K8 must never run on two streams;
- the launches a capture records for each kernel wrapper
  (ops/_lib.py ``tally``) are added to its count at every replay.

On the CPU the same body runs eagerly, frame by frame, and nothing touches
``torch.cuda``.  :class:`EagerFrameScan` runs every frame eagerly on a
CUDA device too: for a body that holds a collective no graph may capture
(a gloo ``all_reduce``, parallel/segment.py), and as the graphed frames'
reference.
"""

from __future__ import annotations

import time
from dataclasses import fields, is_dataclass, replace
from typing import Callable, Dict, List, Optional

import torch

from rvio_tpu_torch.ops import _lib
from rvio_tpu_torch.utils.profiling import span

# device index -> (stream, memory pool, the graph that holds the pool, its
# buffer): the stream and pool every graph of the device shares
_shared: Dict[int, tuple] = {}


def tree_leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of dataclasses, tuples, lists and dicts, in
    field, item and key order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if is_dataclass(x):
        x = [getattr(x, f.name) for f in fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    elif not isinstance(x, (tuple, list)):
        raise TypeError(f"not a tensor nest: {type(x).__name__}")
    return [leaf for item in x for leaf in tree_leaves(item)]


def tree_map(fn: Callable, x):
    """``fn`` over the tensors of a nest (see :func:`tree_leaves`), in the
    nest's structure."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if is_dataclass(x):
        return replace(x, **{f.name: tree_map(fn, getattr(x, f.name))
                             for f in fields(x)})
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    raise TypeError(f"not a tensor nest: {type(x).__name__}")


def _store(bufs, new) -> None:
    """Copy the nest ``new`` into the buffers ``bufs``.  A new leaf that is
    its buffer is left alone; one that shares memory with a buffer (a
    view, or another field passed through) is cloned before any buffer is
    written."""
    pairs = [(b, n) for b, n in zip(tree_leaves(bufs), tree_leaves(new),
                                    strict=True) if n is not b]
    held = {b.untyped_storage().data_ptr() for b, _ in pairs}
    srcs = [n.clone() if n.untyped_storage().data_ptr() in held else n
            for _, n in pairs]
    for (b, _), n in zip(pairs, srcs):
        b.copy_(n)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def device_stream(device: torch.device):
    """The stream and memory pool every graph of ``device`` is captured
    and replayed with (created at the first call)."""
    index = _device_index(device)
    got = _shared.get(index)
    if got is None:
        with torch.cuda.device(index):
            stream = torch.cuda.Stream()
            pool = torch.cuda.graph_pool_handle()
            # A pool whose graphs are all gone cannot be captured into
            # again (the allocator asserts), so one graph of a single add
            # holds it for the life of the process.
            anchor = torch.cuda.CUDAGraph()
            count = torch.zeros(1, device=f"cuda:{index}")
            with torch.cuda.graph(anchor, pool=pool, stream=stream):
                count.add_(1)
            got = _shared[index] = (stream, pool, anchor, count)
    return got[:2]


class FrameScan:
    """``body(carry, frame) -> (carry, outputs)`` over stacked frames.

    ``frame`` is a dict of one frame's tensors (row t of each stacked
    input), ``outputs`` a dict of tensors.  :meth:`__call__` is the scan
    (``scan(carry, frames) -> (carry, outputs)``, both copies the next call
    leaves alone); :meth:`load` and :meth:`run` are its halves on the
    static buffers.  ``unroll`` frames go into one graph.

    ``captures`` lists each capture: frames in the graph, seconds, and
    ``reserved_growth_bytes``, the growth of the caching allocator's
    reserved bytes across it: the whole segments the device's shared pool
    had to add for the graph's working memory, 0 where the pool, which
    graphs replayed one at a time share, already held enough (so not the
    graph's working memory itself, which no reading of the pool gives
    without resetting the process's peak statistics).  A capture leaves
    the process's peak memory statistics alone.

    Spans (utils/profiling.py): ``frame_scan.warm`` (the eager first
    frame), ``frame_scan.capture`` (one capture) and ``frame_scan.replay``
    (one ``graph.replay()`` on the host), on a CUDA device only.
    """

    def __init__(self, body: Callable, device: torch.device,
                 unroll: int = 1):
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        self.body = body
        self.device = torch.device(device)
        self.unroll = unroll
        self.carry = None
        self.captures: List[dict] = []
        self._table: Optional[Dict[str, torch.Tensor]] = None
        self._key = None
        self._outs: Optional[Dict[str, torch.Tensor]] = None
        self._cursor: Optional[torch.Tensor] = None
        self._graphs: Dict[int, tuple] = {}
        self._warm = False
        self._caller = None     # the stream a CUDA run was called on

    def load(self, carry) -> None:
        """Make ``carry`` the scan's carry: copied into the carry's buffers
        (allocated at the first call), leaf by leaf, where a leaf is not
        its buffer already."""
        if self.carry is None:
            self.carry = tree_map(torch.clone, carry)
        else:
            _store(self.carry, carry)

    def __call__(self, carry, frames: Dict[str, torch.Tensor]):
        """Run the frames from ``carry``; returns copies of the final carry
        and of the (T, ...) outputs."""
        self.load(carry)
        outs = self.run(frames)
        return (tree_map(torch.clone, self.carry),
                {k: v.clone() for k, v in outs.items()})

    def run(self, frames: Dict[str, torch.Tensor],
            static=None) -> Dict[str, torch.Tensor]:
        """Run the T frames stacked in ``frames`` from the loaded carry.
        Returns the first T rows of the output table: static buffers that
        the next run overwrites.  ``static`` is anything hashable the body
        bakes into a graph besides the frames' shapes; a change recaptures."""
        T = len(next(iter(frames.values())))
        if T == 0:
            return {}
        self._fill(frames, static)
        if self.device.type == "cuda":
            self._caller = torch.cuda.current_stream(self.device)
            self._run_graphed(T)
        else:
            for _ in range(T):
                self._frame()
        return {k: v[:T] for k, v in self._outs.items()}

    def _run_graphed(self, T: int) -> None:
        """T frames on the graph stream: the first after the buffers were
        allocated eagerly, the others as replays."""
        current = self._caller
        stream, _ = device_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            if not self._warm:
                with span("frame_scan.warm"):
                    self._frame()
                self._warm = True
                T -= 1
            while T > 0:
                u = self.unroll if T >= self.unroll else 1
                self._replay(u)
                T -= u
        current.wait_stream(stream)

    def _fill(self, frames, static) -> None:
        """Copy the frames into the input table, reallocating it (and
        dropping the graphs, which read its old address) where it is too
        short or the frames' shapes or ``static`` changed; the cursor to
        row 0."""
        T = len(next(iter(frames.values())))
        key = (static, tuple((k, tuple(v.shape[1:]), v.dtype)
                             for k, v in frames.items()))
        if self._table is None or key != self._key or \
                T > len(next(iter(self._table.values()))):
            self._table = {k: torch.empty((T,) + tuple(v.shape[1:]),
                                          dtype=v.dtype, device=self.device)
                           for k, v in frames.items()}
            self._key = key
            self._cursor = torch.zeros(1, dtype=torch.long,
                                       device=self.device)
            self._outs = None
            self._graphs = {}
            self._warm = False
        for k, v in frames.items():
            self._table[k][:T].copy_(v)
        self._cursor.zero_()

    def _frame(self) -> None:
        """One frame on the buffers: read row ``cursor``, run the body,
        store the carry and the outputs, advance the cursor."""
        frame = {k: t.index_select(0, self._cursor)[0]
                 for k, t in self._table.items()}
        carry, outs = self.body(self.carry, frame)
        _store(self.carry, carry)
        if self._outs is None:
            self._alloc_outs(outs)
        for k, t in self._outs.items():
            t.index_copy_(0, self._cursor, outs[k].unsqueeze(0))
        self._cursor.add_(1)

    def _alloc_outs(self, outs) -> None:
        """The output table, shaped after the first frame's outputs.  On
        CUDA it is allocated on the caller's stream, as the other buffers
        are, and the graph stream waits for that stream before writing it;
        then whatever the caller does with it after a run is ordered after
        the graph stream's work (a run ends with the caller's stream
        waiting for the graph stream)."""
        rows = len(next(iter(self._table.values())))

        def alloc():
            return {k: torch.empty((rows,) + tuple(v.shape), dtype=v.dtype,
                                   device=self.device)
                    for k, v in outs.items()}

        if self.device.type != "cuda":
            self._outs = alloc()
            return
        with torch.cuda.stream(self._caller):
            self._outs = alloc()
        torch.cuda.current_stream(self.device).wait_stream(self._caller)

    def _replay(self, u: int) -> None:
        got = self._graphs.get(u)
        if got is None:
            got = self._graphs[u] = self._capture(u)
        graph, counts = got
        with span("frame_scan.replay"):
            graph.replay()
        for wrapper, n in counts.items():
            wrapper.launches += n

    def _capture(self, u: int):
        stream, pool = device_stream(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with span("frame_scan.capture", frames=u), \
                    _lib.tally() as counts:
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="global"):
                    for _ in range(u):
                        self._frame()
        except BaseException:
            # the allocator stays recording into a pool whose capture
            # failed, so the device's later captures take a fresh pool
            # (and stream); the error goes on to the caller
            _shared.pop(_device_index(self.device), None)
            raise
        self.captures.append(dict(
            frames=u, seconds=time.perf_counter() - t0,
            reserved_growth_bytes=torch.cuda.memory_reserved(self.device)
            - reserved))
        return graph, dict(counts)


class EagerFrameScan(FrameScan):
    """A :class:`FrameScan` whose frames all run eagerly, on the caller's
    stream: the same body, buffers and cursor, and no graph."""

    def _run_graphed(self, T: int) -> None:
        for _ in range(T):
            self._frame()
