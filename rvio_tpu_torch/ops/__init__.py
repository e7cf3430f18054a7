"""Hand-written CUDA kernels of the per-frame path.

Each module holds its kernels' wrappers (which launch the CUDA kernel for
a CUDA tensor and count their launches in ``<wrapper>.launches``), their
plain PyTorch versions (taken for a CPU tensor) and a note on what bounds
them.  Filter: ``propagate_block`` (K1), ``lm_triangulate`` (K2),
``jac_project`` (K3), ``spd_solve`` (K4).  Image front-end:
``tile_gather`` (``gather_tiles`` K6, ``gather_tiles_aligned`` K7),
``klt_iterate`` (``lk_level`` K8, ``subpix_refine`` K9), ``clahe``
(``clahe_luts`` K10, ``clahe_apply`` K11), ``shi_tomasi`` (``shi_tomasi``
K12, ``shi_tomasi_nms`` K13).  Sources
are in ``csrc/``; ``_lib`` builds and loads them; ``checks`` holds each
kernel against its plain version.
"""
