"""Multi-process data parallelism (parallel/mesh.py)."""
