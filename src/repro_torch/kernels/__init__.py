"""Hand-written Hopper kernels for the perf-critical hot spots:

  * ``spmm`` — blocked-ELL SpMM (CUDA C++, ``csrc/spmm_blocked_ell.cu``),
    the port of the TPU kernel ``repro/kernels/spmm.py:spmm_blocked_ell``
  * ``swa`` — banded sliding-window flash attention (CUDA C++,
    ``csrc/swa_attention.cu``), the port of the TPU kernel
    ``repro/kernels/swa.py:swa_attention_pallas``

Each kernel ships with its plain PyTorch version beside it (used on CPU
tensors and as the comparison on the card), a launch counter, and an oracle
in ref.py. ``_build`` compiles the CUDA sources at first use.
"""
from .spmm import (csr_to_blocked_ell, spmm_blocked_ell,
                   spmm_blocked_ell_plain, to_blocked_ell)
from .swa import swa_attention, swa_attention_plain
from .ops import BlockedEll, spmm_op, swa_attention_op
from . import ref
