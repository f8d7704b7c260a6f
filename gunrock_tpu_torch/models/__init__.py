from .bfs import bfs, bfs_device, BfsResult  # noqa: F401
