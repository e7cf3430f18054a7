"""The plain versions of the filter's and the tracker's operations (the
kernel wrappers are kept as they were frozen; ``_lib`` sends every call
to the plain version)."""
