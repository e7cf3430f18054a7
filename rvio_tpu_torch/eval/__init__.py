"""Trajectory evaluation (numpy copy of the JAX package's): ATE/RPE."""

from rvio_tpu_torch.eval.ate import umeyama_alignment, ate_rmse, rpe_rmse

__all__ = ["umeyama_alignment", "ate_rmse", "rpe_rmse"]
