"""Hand-written CUDA kernels of the filter's per-frame path.

Each module holds one kernel's wrapper (which launches the CUDA kernel for
a CUDA tensor and counts its launches in ``<wrapper>.launches``), its
plain PyTorch version (taken for a CPU tensor) and a note on what bounds
it: ``propagate_block`` (K1), ``lm_triangulate`` (K2), ``jac_project``
(K3), ``spd_solve`` (K4).  Sources are in ``csrc/``; ``_lib`` builds and
loads them; ``checks`` holds each kernel against its plain version.
"""
