"""Fixed-shape robocentric filter state and its window operations."""

from benchmark.reference.rvio_plain.state.filter_state import (
    FilterState,
    StateIndex,
    clone_err_slice,
    make_initial_state,
    stack_states,
    state_from_numpy,
    state_to_numpy,
    static_initialize,
)
from benchmark.reference.rvio_plain.state.window import augment_window, compose_state

__all__ = [
    "FilterState", "StateIndex", "clone_err_slice", "make_initial_state",
    "stack_states", "state_from_numpy", "state_to_numpy", "static_initialize",
    "augment_window", "compose_state",
]
