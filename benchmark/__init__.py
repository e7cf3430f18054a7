"""The benchmark of rvio_tpu_torch on one CUDA card.

One command runs one cell once (see run.py).  Everything that belongs to
one configuration, traffic mix, per-layer metric or cell's limits is a
file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it.
"""
