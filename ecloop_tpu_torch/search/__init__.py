"""Search engines of the port; submodules are imported on demand."""
