"""Data IO (numpy copies of the JAX package's): synthetic simulator, TUM format."""

from rvio_tpu_torch.dataio.synthetic import SyntheticSequence, simulate_sequence
from rvio_tpu_torch.dataio.tum import write_tum, read_tum

__all__ = ["SyntheticSequence", "simulate_sequence", "write_tum", "read_tum"]
