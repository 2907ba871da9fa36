"""Hand-written Hopper kernels for the perf-critical hot spots:

  * ``spmm`` — two SpMM kernels for the TPU kernel
    ``repro/kernels/spmm.py:spmm_blocked_ell``: the row-wise CSR kernel
    (CUDA C++, ``csrc/spmm_csr_rows.cu``), the GCN path's SpMM, and the
    port of the TPU kernel's literal blocked-ELL interface (CUDA C++,
    ``csrc/spmm_blocked_ell.cu``), off the path
  * ``swa`` — banded sliding-window flash attention, the port of the TPU
    kernel ``repro/kernels/swa.py:swa_attention_pallas``: bf16 ``wgmma``
    with TMA-fed stages (CUDA C++, ``csrc/swa_attention_wgmma.cu``), the
    bf16 prefill paths' at D 64, 128 and 256, and float32 FMA (CUDA C++,
    ``csrc/swa_attention.cu``) for float32
  * ``ssd`` — the Mamba2 SSD chunk scan, the port of the TPU kernel
    ``repro/kernels/ssd.py:ssd_chunked_pallas``: three chunk-parallel
    kernels on bf16 tensor cores (CUDA C++, ``csrc/ssd_chunk_tc.cu``), the
    prefill path's, and float32 FMA with the chunk loop in one kernel
    (CUDA C++, ``csrc/ssd_chunked.cu``) for float32 and other bf16 shapes

Each kernel ships with its plain PyTorch version beside it (used on CPU
tensors and as the comparison on the card) and a launch counter; ref.py
holds the SpMM and SWA oracles (the SSD's is its plain version, as the JAX
package's is the model zoo's ``ssd_chunked``). ``_build`` compiles the CUDA sources at first use.
"""
from .spmm import (csr_to_blocked_ell, spmm_blocked_ell,
                   spmm_blocked_ell_plain, spmm_csr_rows, spmm_csr_rows_plain,
                   to_blocked_ell)
from .swa import (swa_attention, swa_attention_fma, swa_attention_plain,
                  swa_attention_wgmma)
from .ssd import (ssd_chunk_out, ssd_chunk_out_plain, ssd_chunk_state,
                  ssd_chunk_state_plain, ssd_chunked, ssd_chunked_fma,
                  ssd_chunked_plain, ssd_chunked_tc, ssd_state_scan,
                  ssd_state_scan_plain)
from .ops import BlockedEll, CsrOperand, spmm_op, swa_attention_op
from . import ref
