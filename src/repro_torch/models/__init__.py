"""Models of the port: the GNN case studies (GCN, GIN), the dense LM
family (prefill, with sliding-window attention on the banded kernel) and
the ssm family (mamba2 prefill, with the SSD chunk scan kernel)."""
from .gnn import (GCN, GIN, gcn_params_from_numpy, gin_params_from_numpy,
                  init_gcn_params, init_gin_params)
from .common import ModelConfig, ParamDecl, init_params, param_count
from .lm import forward, lm_params_from_numpy, model_decls
