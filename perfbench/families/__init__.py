"""One module a model family, named as a configuration's ``as_run``
``family``: what the benchmark knows of the family's architecture, frozen
here so that the program's own code may change under it.

A family module has

- ``layout(cfg)``: the family's parameters beside the embedding, the final
  norm and an untied head (``weights.layout``), ``{name: (shape, init)}``
  nested like the program's tree, per-layer leaves stacked on a leading
  axis;
- ``layers(params, cfg, prec)``: the reference's layers in order, each a
  function of the residual stream (``reference/lm.py``);
- ``forward_flops(cfg, b, L)``: the model FLOPs of one forward over b rows
  of L tokens, the unembedding left out (``counts.py``);
- ``ssd_calls(cfg)`` and ``dims(cfg)``: the SSD scans of one forward,
  and their (inner width, heads, head size, state size).

A configuration of a new family adds a module here; nothing else changes.
"""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"families.{name}")
