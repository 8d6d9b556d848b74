"""Multi-process training: the process group, the mesh, data parallelism."""
