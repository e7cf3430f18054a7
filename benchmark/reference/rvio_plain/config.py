"""Configuration schema for rvio_tpu_torch (a copy of rvio_tpu/config.py).

The reference scatters `cv::FileStorage` reads across every constructor
(reference: src/rvio/System.cc:53-91, Tracker.cc:39-79, PreIntegrator.cc:32-38,
Ransac.cc:34-46, Updater.cc:40-63, FeatureDetector.cc:31-49) with no defaults
or validation.  Here the full parameter surface lives in one typed, validated
dataclass.  Two loaders are provided:

- :func:`load_config` — plain YAML in our native schema.
- :func:`load_reference_config` — reads the reference's OpenCV-style YAML
  (e.g. rvio_euroc.yaml) directly, so a reference user can bring their
  config file unchanged.

TPU-specific compile-time shape knobs (feature budget, IMU block size, clone
window) also live here: they are baked into jitted programs, so changing them
recompiles.

In the PyTorch port the tensor's device, not the config, selects kernels:
``tpu.use_pallas``, ``tpu.klt_fused`` and ``tpu.ekf_tail_fused`` select
nothing.  ``tpu.parallel_propagation`` selects the form of the window
chain (filter/update.window_pose_chain) and of IMU propagation off the
card (filter/propagation.propagate: a CUDA f32 state always runs kernel
K1), as in the JAX package; the segment-batched scans keep both
sequential.  The Cholesky compression and EKF core are kernel K5
(ops/ekf_tail.py) on a CUDA tensor at every window.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


@dataclass(frozen=True)
class ImuConfig:
    """IMU noise / rate parameters (reference: config/rvio_euroc.yaml:8-20)."""

    rate_hz: float = 200.0            # IMU.dps
    sigma_g: float = 1.6968e-4        # gyro noise density
    sigma_wg: float = 1.9393e-5       # gyro random walk
    sigma_a: float = 2.0e-3           # accel noise density
    sigma_wa: float = 3.0e-3          # accel random walk
    gravity: float = 9.8082           # IMU.nG
    small_angle: float = 0.001745329  # IMU.nSmallAngle [rad]


@dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics/extrinsics (reference: config/rvio_euroc.yaml:27-65)."""

    fps: float = 20.0
    is_rgb: bool = False
    is_fisheye: bool = False
    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    k1: float = -0.28340811
    k2: float = 0.07395907
    p1: float = 0.00019359
    p2: float = 1.76187114e-05
    k3: float = 0.0
    sigma_px: float = 0.002180293     # image noise in normalized coords (1/f)
    sigma_py: float = 0.002186767
    # T_BC0 row-major 4x4: camera-to-IMU transform (reference: Updater.cc:46-53)
    T_BC0: tuple = (
        0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
        0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
        0.0, 0.0, 0.0, 1.0,
    )
    time_offset: float = 0.0          # Camera.nTimeOffset: t_imu = t_cam + offset

    @property
    def R_bc(self) -> np.ndarray:
        """Rotation IMU<-camera (mRic in reference Updater.cc:50)."""
        return np.asarray(self.T_BC0, dtype=np.float64).reshape(4, 4)[:3, :3]

    @property
    def t_bc(self) -> np.ndarray:
        """Translation IMU<-camera (mtic in reference Updater.cc:51)."""
        return np.asarray(self.T_BC0, dtype=np.float64).reshape(4, 4)[:3, 3]

    @property
    def sigma_image(self) -> float:
        """max(sigma_px, sigma_py) (reference: Updater.cc:44)."""
        return max(self.sigma_px, self.sigma_py)


@dataclass(frozen=True)
class TrackerConfig:
    """Front-end parameters (reference: config/rvio_euroc.yaml:72-97)."""

    num_features: int = 200           # Tracker.nFeatures (feature slot budget N)
    max_tracking_length: int = 15     # Tracker.nMaxTrackingLength (L)
    min_tracking_length: int = 3      # Tracker.nMinTrackingLength
    min_distance: float = 15.0        # Tracker.nMinDist [px]
    quality_level: float = 0.01       # Tracker.nQualLvl (Shi-Tomasi rel. threshold)
    # Sub-pixel refinement of per-frame REFILL candidates (the reference
    # runs cornerSubPix on every detection, FeatureDetector.cc:66-71).
    # Measured: ATE-neutral on the clean flagship image workload (0.0138
    # with vs 0.0130 without) but +16 % ATE under photometric stress
    # (0.0130 -> 0.0151) where grid peaks are noisy — so it stays ON by
    # default; disabling saves ~0.06 ms/frame (the scattered tile-gather
    # DMA floor) in controlled conditions.  First-frame/init detection
    # keeps sub-pixel always.
    subpix_refill: bool = True
    # cornerSubPix iteration budget.  The reference allows up to 30 with
    # a 1e-2 early exit (FeatureDetector.cc:70); real corners converge in
    # 2-3.  The fixed-iteration kernel's gather-tile size (and so its DMA
    # traffic) scales with the drift bound = iters * 1 px/iter.
    subpix_iters: int = 10
    block_size_x: int = 150           # chess-grid block (refill occupancy)
    block_size_y: int = 120
    enable_equalizer: bool = True     # CLAHE preprocessing
    use_sampson: bool = True          # RANSAC scoring (else algebraic)
    inlier_threshold: float = 1e-5    # RANSAC inlier error threshold
    # KLT parameters (reference hard-codes: Tracker.cc:237-244)
    klt_window: int = 15              # LK window (15x15)
    klt_levels: int = 3               # pyramid max level (4 levels: 0..3)
    klt_max_iters: int = 30
    klt_eps: float = 1e-2
    klt_min_eig: float = 1e-3
    ransac_iterations: int = 16       # fixed hypothesis count (Ransac.h:52-58)

    @property
    def max_update_features(self) -> int:
        """ceil(N/2) update batch cap (reference: Tracker.cc:74)."""
        return math.ceil(0.5 * self.num_features)


@dataclass(frozen=True)
class InitConfig:
    """Static-initialization gate (reference: config/rvio_euroc.yaml:104-111)."""

    threshold_angle: float = 0.005    # [rad] motion gate
    threshold_displ: float = 0.01     # [m] motion gate
    enable_alignment: bool = True     # gravity-align the {G} frame
    record_outputs: bool = False      # write TUM pose + timing files
    # Initial velocity prior std [m/s].  The reference leaves the velocity
    # variance at exactly zero (System.cc:154-169), which makes the filter
    # inconsistent whenever the motion gate fires after real motion onset;
    # set to 0.0 for strict reference parity.
    sigma_v0: float = 0.1
    # Freeze the static bias averages at detected motion ONSET instead of
    # at gate firing.  The reference averages every pre-gate IMU sample
    # into the gyro/accel bias init (System.cc:217-249); with a slow
    # motion onset the per-frame gate stays quiet for a second or more of
    # real sub-threshold rotation, poisoning the bias init by up to the
    # ramp rate (measured: 0.008 rad/s on a 5 s smoothstep ramp -> 7 deg/
    # min yaw drift).  Onset is detected on the DETRENDED cumulative
    # angle (deviation from the running mean, so a true constant bias
    # never trips it) at 0.5x threshold_angle.  False = strict parity.
    freeze_bias_average: bool = True
    # Transport the frozen attitude/gravity average from motion onset to
    # the gate-fire frame by integrating the (bias-corrected) gyro over
    # the onset->fire gap.  The reference initializes attitude directly
    # from the running average (System.cc:119-140), so the sub-threshold
    # rotation before the gate fires becomes a CONSTANT unobservable
    # attitude error of the {G} frame (~1.5 deg measured on the drive
    # ramp -> ~2 % of path as pure lateral drift).  False = strict parity.
    forward_rotate_attitude: bool = True


@dataclass(frozen=True)
class LandmarkConfig:
    """Landmark visualization (reference: config/rvio_euroc.yaml:118-121).

    The reference publishes accepted landmarks as rviz cube markers of edge
    ``nScale`` with lifetime ``1/nPubRate`` s (Updater.cc:59-63,83-85);
    headless here: marker radius in the SVG plot and the cloud decimation
    rate for the recorded landmark file.
    """

    scale: float = 0.03               # Landmark.nScale [m] marker size
    pub_rate: float = 5.0             # Landmark.nPubRate [Hz]


@dataclass(frozen=True)
class TpuConfig:
    """TPU-native compile-time knobs (no reference equivalent — new design)."""

    dtype: str = "float32"            # compute dtype for the filter
    imu_block: int = 16               # padded IMU samples per frame (<=11 real @200/20Hz;
                                      # the unrolled propagation scan scales with this)
    use_pallas: bool = True           # Pallas kernels for hot image ops (else XLA)
    # Fused Pallas LK kernel (ops/klt_iterate.py): the whole per-level
    # iteration loop in one kernel, ~8x faster than the XLA tile path on
    # TPU.  Applies only when use_pallas and running on TPU.
    klt_fused: bool = True
    # Measurement compression: "cholesky" (Gram/information form — pure
    # MXU, fastest at nominal scale, tiny structural ridge) or "qr" (exact
    # information; on TPU a CholeskyQR2-TSQR tree — XLA's Householder-QR
    # lowering hangs the TPU compiler at tall shapes — and the faster
    # choice at stress scale; Householder TSQR/thin-QR on CPU).
    compression: str = "cholesky"
    # IMU propagation as batched term construction + parallel-prefix scans
    # (log-depth) instead of the reference-shaped per-sample loop; same
    # math, different fp summation order (filter/propagation.py).
    parallel_propagation: bool = True
    # First-estimates Jacobians in the MSCKF update: linearize the window
    # chain at the clones' augmentation-time values (filter/update.py)
    # instead of relinearizing at current estimates every frame like the
    # reference (Updater.cc:118-141).  Kills the spurious relative-pose/
    # scale information leak that compounds into yaw drift on long drives;
    # False = strict reference parity.
    fej: bool = False
    # Innovation-based online calibration of the image-noise variance
    # (filter/update.py): the reference pins sigma to the config value
    # forever (Updater.cc:44); an over-stated sigma feeds the weakly-
    # observable yaw/gyro-bias drift equilibrium (16x end-drift effect
    # measured on the drive workload).  False = strict reference parity.
    # Measured (5-min noisy drive): end drift 0.66 -> 0.33 %, ATE 1.26 ->
    # 0.24 m; flagship bounded ATE 0.0102 -> 0.0082 m.
    adaptive_noise: bool = True
    # Frames over which DOWNWARD noise adaptation ramps to full rate
    # (0 = immediately).  Warm-handoff segments start with an inflated
    # scale and must not tighten before the filter converges
    # (parallel/handoff.py sets this to the warm-up length); nominal
    # static-init runs keep 0.
    adaptive_rampup_frames: int = 0
    # The JAX package's switch for its fused compression + EKF-core
    # kernel; read from YAML, selects nothing here (K5 always runs on CUDA).
    ekf_tail_fused: bool = False
    donate_state: bool = True         # donate state buffers through the jitted step


@dataclass(frozen=True)
class RVIOConfig:
    imu: ImuConfig = field(default_factory=ImuConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    init: InitConfig = field(default_factory=InitConfig)
    landmark: LandmarkConfig = field(default_factory=LandmarkConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    @property
    def window_size(self) -> int:
        """Clone window M = nMaxTrackingLength - 1 (reference: System.cc:71-72)."""
        return self.tracker.max_tracking_length - 1

    @property
    def min_clone_states(self) -> int:
        """Update only after this many clones (reference: System.cc:74-75)."""
        return self.tracker.min_tracking_length - 1

    @property
    def state_dim(self) -> int:
        """Full state dim 26 + 7M (reference layout, SURVEY.md section 2.1)."""
        return 26 + 7 * self.window_size

    @property
    def err_dim(self) -> int:
        """Error-state dim 24 + 6M."""
        return 24 + 6 * self.window_size

    def replace(self, **kw) -> "RVIOConfig":
        return dataclasses.replace(self, **kw)


def _build(section_cls, data: dict, prefix_map: dict):
    kwargs = {}
    for yaml_key, field_name in prefix_map.items():
        if yaml_key in data:
            kwargs[field_name] = data[yaml_key]
    return section_cls(**kwargs)


# Mapping from the reference's flat cv::FileStorage keys to our schema.
_REF_IMU = {
    "IMU.dps": "rate_hz", "IMU.sigma_g": "sigma_g", "IMU.sigma_wg": "sigma_wg",
    "IMU.sigma_a": "sigma_a", "IMU.sigma_wa": "sigma_wa", "IMU.nG": "gravity",
    "IMU.nSmallAngle": "small_angle",
}
_REF_CAM = {
    "Camera.fps": "fps", "Camera.RGB": "is_rgb", "Camera.Fisheye": "is_fisheye",
    "Camera.width": "width", "Camera.height": "height",
    "Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx", "Camera.cy": "cy",
    "Camera.k1": "k1", "Camera.k2": "k2", "Camera.p1": "p1", "Camera.p2": "p2",
    "Camera.k3": "k3", "Camera.sigma_px": "sigma_px", "Camera.sigma_py": "sigma_py",
    "Camera.T_BC0": "T_BC0", "Camera.nTimeOffset": "time_offset",
}
_REF_TRACKER = {
    "Tracker.nFeatures": "num_features",
    "Tracker.nMaxTrackingLength": "max_tracking_length",
    "Tracker.nMinTrackingLength": "min_tracking_length",
    "Tracker.nMinDist": "min_distance", "Tracker.nQualLvl": "quality_level",
    "Tracker.nBlockSizeX": "block_size_x", "Tracker.nBlockSizeY": "block_size_y",
    "Tracker.EnableEqualizer": "enable_equalizer",
    "Tracker.UseSampson": "use_sampson", "Tracker.nInlierThrd": "inlier_threshold",
}
_REF_INIT = {
    "INI.nThresholdAngle": "threshold_angle",
    "INI.nThresholdDispl": "threshold_displ",
    "INI.EnableAlignment": "enable_alignment",
    "INI.RecordOutputs": "record_outputs",
}
_REF_LANDMARK = {
    "Landmark.nScale": "scale", "Landmark.nPubRate": "pub_rate",
}


def _coerce_bools(cfg_cls, kwargs: dict) -> dict:
    out = dict(kwargs)
    for f in dataclasses.fields(cfg_cls):
        if f.name in out and f.type == "bool":
            out[f.name] = bool(out[f.name])
    return out


def config_from_flat(flat: dict) -> RVIOConfig:
    """Build an RVIOConfig from a flat reference-style key->value mapping."""
    imu = ImuConfig(**_coerce_bools(ImuConfig, {v: flat[k] for k, v in _REF_IMU.items() if k in flat}))
    cam_kw = {v: flat[k] for k, v in _REF_CAM.items() if k in flat}
    if "T_BC0" in cam_kw:
        cam_kw["T_BC0"] = tuple(np.asarray(cam_kw["T_BC0"], dtype=np.float64).reshape(-1).tolist())
    cam = CameraConfig(**_coerce_bools(CameraConfig, cam_kw))
    trk = TrackerConfig(**_coerce_bools(TrackerConfig, {v: flat[k] for k, v in _REF_TRACKER.items() if k in flat}))
    ini = InitConfig(**_coerce_bools(InitConfig, {v: flat[k] for k, v in _REF_INIT.items() if k in flat}))
    lmk = LandmarkConfig(**{v: flat[k] for k, v in _REF_LANDMARK.items() if k in flat})
    return RVIOConfig(imu=imu, camera=cam, tracker=trk, init=ini, landmark=lmk)


def load_reference_config(path: str) -> RVIOConfig:
    """Read an OpenCV-style YAML settings file (the reference's format).

    Tolerates the ``%YAML:1.0`` directive and ``!!opencv-matrix`` tags that
    stock PyYAML rejects, so reference config files work verbatim.
    """
    if yaml is None:
        raise RuntimeError("pyyaml is required to parse config files")
    with open(path, "r") as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    text = "\n".join(lines).replace("!!opencv-matrix", "!opencv-matrix")

    class _Loader(yaml.SafeLoader):
        pass

    def _cv_matrix(loader, node):
        m = loader.construct_mapping(node, deep=True)
        return np.asarray(m["data"], dtype=np.float64).reshape(m["rows"], m["cols"])

    _Loader.add_constructor("!opencv-matrix", _cv_matrix)
    flat = yaml.load(text, Loader=_Loader) or {}
    return config_from_flat(flat)


def load_config(path: str) -> RVIOConfig:
    """Load a native nested-YAML config; fall back to reference format."""
    if yaml is None:
        raise RuntimeError("pyyaml is required to parse config files")
    with open(path, "r") as f:
        head = f.read(64)
    if head.startswith("%YAML") or "IMU.dps" in open(path).read():
        return load_reference_config(path)
    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    sections = {}
    for name, cls in (("imu", ImuConfig), ("camera", CameraConfig),
                      ("tracker", TrackerConfig), ("init", InitConfig),
                      ("landmark", LandmarkConfig), ("tpu", TpuConfig)):
        if name in data:
            kw = _coerce_bools(cls, data[name])
            if name == "camera" and "T_BC0" in kw:
                kw["T_BC0"] = tuple(np.asarray(kw["T_BC0"], dtype=np.float64).reshape(-1).tolist())
            sections[name] = cls(**kw)
    return RVIOConfig(**sections)


EUROC_CONFIG = RVIOConfig()
