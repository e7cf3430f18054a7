"""Hand-written CUDA kernels of the per-frame path.

Each module holds its kernels' wrappers (which launch the CUDA kernel for
a CUDA tensor and count their launches in ``<wrapper>.launches``), their
plain PyTorch versions (taken for a CPU tensor) and a note on what bounds
them.  Filter: ``propagate_block`` (K1), ``lm_triangulate`` (K2),
``jac_project`` (K3), ``spd_solve`` (K4).  Image front-end:
``tile_gather`` (K6), ``klt_iterate`` (``lk_level`` K8,
``subpix_refine`` K9), ``shi_tomasi`` (``shi_tomasi_nms`` K13).  Sources
are in ``csrc/``; ``_lib`` builds and loads them; ``checks`` holds each
kernel against its plain version.
"""
