"""Data parallelism across processes (parallel/mesh.py)."""
