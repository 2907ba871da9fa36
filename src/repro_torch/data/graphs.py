"""Table-I graph dataset builders (synthetic S1-S4 + ogbn-shaped stand-ins).

The two OGB datasets are generated with the published vertex/edge/feature
statistics (Table I); the synthetic S1-S4 sets were synthetic in the paper
too. The numpy streams are those of the JAX package, so both build the same
graphs and features. ``scaled_dataset`` shrinks a dataset by a factor for
CPU-sized tests while preserving its degree/feature profile.
"""
from __future__ import annotations

import numpy as np

from ..core.workload import DATASETS, GraphDataset
from ..sparse import CSR, random_graph_csr


def table1_graph(name: str, *, scale: float = 1.0, seed: int = 0,
                 device=None) -> CSR:
    ds = DATASETS[name]
    v = max(int(ds.vertices * scale), 16)
    e = max(int(ds.edges * scale * scale), v)
    return random_graph_csr(v, e, seed=seed, device=device)


def table1_features(name: str, *, scale: float = 1.0, seed: int = 0):
    ds = DATASETS[name]
    v = max(int(ds.vertices * scale), 16)
    rng = np.random.default_rng(seed + 1)
    return rng.normal(size=(v, ds.feature_len)).astype(np.float32)


def scaled_dataset(name: str, scale: float) -> GraphDataset:
    ds = DATASETS[name]
    return GraphDataset(f"{ds.name}@{scale:g}",
                        max(int(ds.vertices * scale), 16),
                        max(int(ds.edges * scale * scale), 16),
                        ds.feature_len)
