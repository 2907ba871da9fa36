"""Architecture config registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``."""
from __future__ import annotations

import importlib

ARCHS = [
    "gemma-2b",
    "qwen3-4b",
    "mistral-large-123b",
    "qwen3-8b",
    "zamba2-7b",
    "mamba2-780m",
    "deepseek-v3-671b",
    "deepseek-v2-236b",
    "seamless-m4t-large-v2",
    "paligemma-3b",
]


def _module(arch: str):
    return importlib.import_module(
        f".{arch.replace('-', '_').replace('.', '_')}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


from .shapes import SHAPES, LONG_SKIP, LONG_VIA_SWA, ShapeSpec, cells  # noqa: E402,F401
