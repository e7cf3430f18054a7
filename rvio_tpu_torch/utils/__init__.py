"""Utilities: the trajectory plot the run CLI writes."""

from rvio_tpu_torch.utils.visualize import plot_trajectory_svg

__all__ = ["plot_trajectory_svg"]
