"""Hand-written CUDA kernels (``csrc/``), the code that builds them, and op wrappers.

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor (``build.load``).
"""
from .ops import xbitmap_count, xinter, xinter_count, xvinter_mac

__all__ = ["xinter", "xinter_count", "xvinter_mac", "xbitmap_count"]
