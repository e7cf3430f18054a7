"""The image front-end: pyramid, detection, KLT, RANSAC and the feature
lifecycle (port of rvio_tpu/frontend)."""

from rvio_tpu_torch.frontend.tracker import TrackerState, make_tracker

__all__ = ["TrackerState", "make_tracker"]
