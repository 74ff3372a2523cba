"""S_VINTER applications (paper §VI-I): sparse x sparse matrix product and
tensor-times-vector, both through the ``vinter`` kernel
(``kernels.ops.xvinter``)."""
from .matrix import SparseCSC, SparseCSR, from_dense, random_sparse
from .spmm import spmsp_matmul
from .ttv import CSFTensor, random_csf, ttv

__all__ = ["SparseCSR", "SparseCSC", "from_dense", "random_sparse",
           "spmsp_matmul", "CSFTensor", "random_csf", "ttv"]
