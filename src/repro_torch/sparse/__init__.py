"""Sparse substrate: CSR formats and SpMM entry points."""
from .formats import CSR, csr_from_dense, csr_to_dense, random_graph_csr
from .spmm import spmm_csr, spmm_dense_ref
