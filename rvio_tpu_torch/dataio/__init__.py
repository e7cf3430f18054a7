"""Data IO (numpy copies of the JAX package's): synthetic simulator, TUM
format, and the replay inputs (EuRoC ASL folders, rosbag v2.0 files and
their PNG and LZ4 codecs, the native PNG batch loader)."""

from rvio_tpu_torch.dataio.synthetic import SyntheticSequence, simulate_sequence
from rvio_tpu_torch.dataio.tum import write_tum, read_tum

__all__ = ["SyntheticSequence", "simulate_sequence", "write_tum", "read_tum"]
