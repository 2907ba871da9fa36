"""Models of the port: the GNN case studies (GCN, GIN)."""
from .gnn import (GCN, GIN, gcn_params_from_numpy, gin_params_from_numpy,
                  init_gcn_params, init_gin_params)
