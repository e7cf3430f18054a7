"""The port's mesh layer in one process (f64, CPU):

- ``make_mesh``'s factorization and its error, raised before any process
  group is touched; the launch helpers' single-process path; the one
  condition (a feat collective) that makes a frame eager; the package's
  modules importing in any order;
- ``shard_states`` / ``shard_bundles`` slicing at each (seg, feat)
  coordinate of a 2x2 mesh, and their errors;
- the feature decomposition of the update: the shard-local partials of
  the halves (and quarters) of F, merged, through the replicated tail,
  against the unsharded ``msckf_update`` in f64 at 1e-10 (Cholesky) and
  1e-8 (QR, the shards' R factors through ``tsqr_compress``), with
  ``adaptive_noise`` on and off and in the mass-rejection case, on a
  batch of two segments; JAX's update beside it;
- a one-rank gloo mesh (a file store under tmp_path): the sharded step
  and sequence are the batched body and scan bitwise, ``gather_segments``
  is the identity, and ``run_segments_warm(mesh=)`` is the ``mesh=None``
  run bitwise.

The multi-rank runs are tests/test_torch_parallel_mp.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import rvio_tpu.filter.update as jupd
from rvio_tpu.state import FilterState as JState
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.bench import feature_bundles
from rvio_tpu_torch.dataio import simulate_sequence
from rvio_tpu_torch.filter.update import (UpdateBatch, merge_partials,
                                          msckf_update, update_partials)
from rvio_tpu_torch.parallel import (gather_segments, host_segment_slice,
                                     initialize_distributed, make_mesh,
                                     make_parallel_sequence,
                                     make_parallel_step, replicate_scalars,
                                     run_segments_warm, shard_bundles,
                                     shard_states, stack_states)
from rvio_tpu_torch.parallel.mesh import (feat_reducer, klt_splitter,
                                          mesh_shape, needs_eager)
from rvio_tpu_torch.runtime import make_batched_sequence_scan
from rvio_tpu_torch.runtime.step import _segment_body
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy
from test_torch_batched import small_cfg
from test_torch_update import R_BC, SIGMA, T_BC, _scene

torch.set_num_threads(1)
F64 = torch.float64


# ---- the mesh and the launch helpers, no process group ----

@pytest.mark.parametrize("n,seg,feat,want", [
    (8, None, None, (8, 1)), (8, None, 2, (4, 2)), (8, 4, None, (4, 2)),
    (1, 1, 1, (1, 1)), (2, 1, 2, (1, 2))])
def test_mesh_shape_defaults(n, seg, feat, want):
    assert mesh_shape(n, seg, feat) == want


@pytest.mark.parametrize("n,seg,feat", [(8, 3, 2), (4, 3, None), (2, 4, 1)])
def test_make_mesh_bad_factorization(n, seg, feat):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n, seg=seg, feat=feat, device_type="cpu")
    assert not dist.is_initialized()


def test_launch_single_process_noop_and_slices():
    initialize_distributed(num_processes=1)       # no-op path
    assert not dist.is_initialized()
    assert host_segment_slice(10) == (0, 10)      # one process owns all


def test_make_mesh_defaults_to_cuda():
    """Without ``device_type`` the mesh is of CUDA ranks, and without a
    CUDA device it raises (as every entry point of the port does)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, seg=2, device_type="cpu")


class _Mesh:
    """A (seg, feat) mesh's coordinates on the CPU, without ranks."""

    device_type = "cpu"

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coord[("seg", "feat").index(name)]

    def get_group(self, name):
        return None


@pytest.mark.parametrize("shape,eager", [
    (None, False), ((1, 1), False), ((2, 1), False), ((1, 2), True),
    ((2, 2), True)])
def test_one_condition_picks_eager_frames(shape, eager):
    """A frame runs eagerly exactly where it holds a feat collective: the
    update's reducer and the KLT's split exist there and nowhere else."""
    mesh = None if shape is None else _Mesh(shape, (0, 0))
    assert needs_eager(mesh) is eager
    assert (feat_reducer(mesh) is not None) is eager
    assert (klt_splitter(mesh, 8) is not None) is eager


def test_klt_splitter_refuses_uneven_lanes():
    with pytest.raises(ValueError, match="must divide feat=2"):
        klt_splitter(_Mesh((1, 2), (0, 1)), 7)


@pytest.mark.parametrize("module", [
    "rvio_tpu_torch.parallel", "rvio_tpu_torch.parallel.mesh",
    "rvio_tpu_torch.runtime", "rvio_tpu_torch.runtime.image_driver",
    "rvio_tpu_torch.frontend.tracker", "rvio_tpu_torch.runtime.step"])
def test_imports_in_any_order(module):
    """The parallel package imports the runtime, which imports the
    tracker; each of these modules imports first in a fresh interpreter."""
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", f"import {module}"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def _bundles(S=4, T=3, F=6, L=5, K=4, seed=0):
    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.runtime.step import FrameBundle
    g = torch.Generator().manual_seed(seed)
    return FrameBundle(
        imu=ImuBlock(w=torch.rand(S, T, K, 3, generator=g),
                     a=torch.rand(S, T, K, 3, generator=g),
                     dt=torch.rand(S, T, K, generator=g),
                     valid=torch.rand(S, T, K, generator=g) > 0.5),
        batch=UpdateBatch(meas=torch.rand(S, T, F, L, 2, generator=g),
                          track_len=torch.randint(0, L, (S, T, F),
                                                  generator=g),
                          is_type2=torch.rand(S, T, F, generator=g) > 0.5,
                          valid=torch.rand(S, T, F, generator=g) > 0.5))


@pytest.mark.parametrize("coord", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_slicing(coord):
    mesh = _Mesh((2, 2), coord)
    c, f = coord
    b = _bundles()
    got = shard_bundles(b, mesh)
    for name in ("w", "a", "dt", "valid"):
        assert torch.equal(getattr(got.imu, name),
                           getattr(b.imu, name)[2 * c:2 * c + 2])
    for name in ("meas", "track_len", "is_type2", "valid"):
        assert torch.equal(getattr(got.batch, name),
                           getattr(b.batch, name)[2 * c:2 * c + 2, :,
                                                  3 * f:3 * f + 3])
    one = shard_bundles(_frame(b), mesh, time_axis=False)
    assert torch.equal(one.batch.meas, b.batch.meas[2 * c:2 * c + 2, 0,
                                                    3 * f:3 * f + 3])
    st = stack_states([state_from_numpy(_scene(seed=s, noise=0.0)[0], "cpu",
                                        F64) for s in range(4)])
    sh = shard_states(st, mesh)
    for fld in dataclasses.fields(st):
        assert torch.equal(getattr(sh, fld.name),
                           getattr(st, fld.name)[2 * c:2 * c + 2])
    rep = replicate_scalars({"x": np.float64(2.0), "y": (1, torch.ones(2))},
                            mesh)
    assert rep["x"].item() == 2.0 and torch.equal(rep["y"][1], torch.ones(2))


def _frame(b):
    from rvio_tpu_torch.state.filter_state import map_fields
    return dataclasses.replace(b, imu=map_fields(lambda x: x[:, 0], b.imu),
                               batch=map_fields(lambda x: x[:, 0], b.batch))


@pytest.mark.parametrize("shape,match", [((3, 1), "segments do not divide"),
                                         ((1, 4), "lanes do not divide")])
def test_shard_refuses_uneven(shape, match):
    with pytest.raises(ValueError, match=match):
        shard_bundles(_bundles(S=4, F=6), _Mesh(shape, (0, 0)))


# ---- the feature decomposition of the update ----

CASES = [("cholesky", True, SIGMA), ("cholesky", False, SIGMA),
         ("qr", True, SIGMA), ("qr", False, SIGMA),
         ("cholesky", True, 1e-5)]       # mass rejection: the escape fires


def _two_scenes(sigma):
    scenes = [_scene(seed=s, noise=5e-4,
                     p_scale=3e-3 if sigma == SIGMA else 1e-7)
              for s in (26, 27)]
    state = stack_states([state_from_numpy(d, "cpu", F64) for d, _ in scenes])
    meas, tlen, typ2, valid = (np.stack(x) for x in
                               zip(*(b for _, b in scenes)))
    batch = UpdateBatch(meas=torch.as_tensor(meas),
                        track_len=torch.as_tensor(tlen).long(),
                        is_type2=torch.as_tensor(typ2),
                        valid=torch.as_tensor(valid))
    return scenes, state, batch


def _lanes(batch, lo, hi):
    return UpdateBatch(**{k: v[:, lo:hi] for k, v in vars(batch).items()})


@pytest.mark.parametrize("compression,adaptive,sigma", CASES)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_feat_decomposition_matches_unsharded(compression, adaptive, sigma,
                                              n_shards):
    scenes, state, batch = _two_scenes(sigma)
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=sigma, compression=compression,
              adaptive_noise=adaptive)
    tail_kw = dict(min_clone_states=2)
    ref, rdiag = msckf_update(state, batch, **kw, **tail_kw)
    F = batch.meas.shape[1]
    per = F // n_shards
    parts = [update_partials(state, _lanes(batch, i * per, (i + 1) * per),
                             **kw) for i in range(n_shards)]
    # shard 0 as a rank sees it: its own lanes, the merged partials
    got, diag = msckf_update(state, _lanes(batch, 0, per), **kw, **tail_kw,
                             feat_reduce=lambda p: merge_partials(
                                 [p] + parts[1:]))
    tol = 1e-10 if compression == "cholesky" else 1e-8
    a, b = state_to_numpy(got), state_to_numpy(ref)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)
    for k in ("n_good", "n_usable", "tl_good_sum", "did_update",
              "ridge_fallback"):
        assert torch.equal(diag[k], rdiag[k]), k
    # merge_partials concatenates the shards' lanes (a rank's reducer
    # keeps its own): every lane as the unsharded update has it
    assert torch.equal(diag["passed"], rdiag["passed"])
    np.testing.assert_allclose(diag["landmarks"][diag["passed"]].numpy(),
                               rdiag["landmarks"][rdiag["passed"]].numpy(),
                               rtol=0, atol=1e-10)
    assert bool(rdiag["did_update"].all()) == (sigma == SIGMA)
    # JAX's update of each segment beside it
    for s, (d, (meas, tlen, typ2, valid)) in enumerate(scenes):
        jst, _ = jupd.msckf_update(
            JState(**{k: jnp.asarray(v) for k, v in d.items()}),
            jupd.UpdateBatch(meas=jnp.asarray(meas),
                             track_len=jnp.asarray(tlen),
                             is_type2=jnp.asarray(typ2),
                             valid=jnp.asarray(valid)),
            min_clone_states=2, **kw)
        for k in ("p_G", "q_G", "v_R", "P", "sigma2_scale"):
            np.testing.assert_allclose(a[k][s], np.asarray(getattr(jst, k)),
                                       rtol=0, atol=tol, err_msg=k)


# ---- a one-rank gloo mesh ----

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    # initialize_distributed is a no-op for one process, so the group of
    # one is made by hand
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def small_run():
    cfg = small_cfg(tconfig)
    built = [feature_bundles(cfg, simulate_sequence(
        cfg, duration=5.0, static_time=1.0, seed=s, meas_noise=5e-4,
        imu_noise=True), "cpu", F64) for s in (1, 2)]
    T = min(int(b[1].imu.w.shape[0]) for b in built)
    states = stack_states([b[0] for b in built])
    bundles = dataclasses.replace(
        built[0][1], imu=_stack_time([b[1].imu for b in built], T),
        batch=_stack_time([b[1].batch for b in built], T))
    return cfg, states, bundles


def _stack_time(objs, T):
    return dataclasses.replace(objs[0], **{
        f.name: torch.stack([getattr(o, f.name)[:T] for o in objs])
        for f in dataclasses.fields(objs[0])})


def test_one_rank_mesh_is_the_batched_scan(one_rank, small_run):
    cfg, states, bundles = small_run
    assert (one_rank.size(0), one_rank.size(1)) == (1, 1)
    fs, out = make_batched_sequence_scan(cfg, "cpu", F64)(states, bundles)
    pfs, pout = make_parallel_sequence(cfg, one_rank, F64)(
        shard_states(states, one_rank), shard_bundles(bundles, one_rank))
    assert set(pout) == {"q_kG", "p_Gk", "v_k", "n_good"}
    for k, v in pout.items():
        assert torch.equal(v, out[k]), k
    for f in dataclasses.fields(fs):
        assert torch.equal(getattr(pfs, f.name), getattr(fs, f.name))
    assert gather_segments(pout, one_rank) is pout
    # one frame through the sharded step and the segment body
    frame = _frame(bundles)
    st1, o1 = make_parallel_step(cfg, one_rank, F64)(states, frame)
    st2, o2 = _segment_body(cfg, "cpu", F64, False)(states, frame)
    for k in o1:
        assert torch.equal(o1[k], o2[k]), k
    assert torch.equal(st1.P, st2.P)


def test_one_rank_mesh_warm_split(one_rank):
    cfg = small_cfg(tconfig)
    sim = simulate_sequence(cfg, duration=14.0, static_time=1.0, seed=5,
                            meas_noise=5e-4, imu_noise=True)
    state0, bundles, _ = feature_bundles(cfg, sim, "cpu", F64)
    ref = run_segments_warm(cfg, state0, bundles, 2, 30, device="cpu")
    got = run_segments_warm(cfg, state0, bundles, 2, 30, mesh=one_rank)
    assert np.array_equal(got[0], ref[0])
    for k, v in ref[1].items():
        assert torch.equal(got[1][k], v), k
    assert got[2]["repaired_segments"] == ref[2]["repaired_segments"]
