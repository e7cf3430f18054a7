"""Utilities: visualization (debug images, the trajectory plot) and the
live viewer (``rvio_tpu_torch.utils.live_viewer``)."""

from rvio_tpu_torch.utils.visualize import (draw_detections, draw_tracks,
                                            plot_trajectory_svg,
                                            save_debug_image)

__all__ = ["draw_tracks", "draw_detections", "save_debug_image",
           "plot_trajectory_svg"]
