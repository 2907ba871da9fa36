"""PyTorch/CUDA port of the DYPE reproduction, for one NVIDIA H100.

The layout mirrors the JAX package: ``repro_torch/X/y.py`` is the
counterpart of ``repro/X/y.py``. This package imports ``torch`` and numpy
only; it keeps its own copy of the DYPE core rather than importing the JAX
package. Entry points take ``device=None``, which means ``"cuda"`` and
raises when no card is present; only a caller that passes ``device="cpu"``
gets the CPU path (the kernels' plain PyTorch versions).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
