"""Models of the port: the GNN case studies (GCN, GIN) and the LM zoo of
every family (dense, with sliding-window attention on the banded kernel;
moe, with MLA and routed experts; ssm and hybrid, with the SSD chunk scan
kernel; encdec; vlm)."""
from .gnn import (GCN, GIN, gcn_params_from_numpy, gin_params_from_numpy,
                  init_gcn_params, init_gin_params)
from .common import ModelConfig, ParamDecl, init_params, param_count
from .lm import encode, forward, lm_loss, lm_params_from_numpy, model_decls
