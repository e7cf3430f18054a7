"""The image front-end: pyramid, detection, KLT, RANSAC and the feature
lifecycle (port of rvio_tpu/frontend)."""

from benchmark.reference.rvio_plain.frontend.tracker import (TrackerState, make_batched_tracker,
                                             make_tracker,
                                             stack_tracker_states)

__all__ = ["TrackerState", "make_batched_tracker", "make_tracker",
           "stack_tracker_states"]
