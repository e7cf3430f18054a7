"""The plain reference that decides ``correct``: a frozen copy of the
tracker, the init gate and the filter (``rvio_plain``) and the frame loops
that drive them (``pipeline``).  Nothing here imports the port."""
