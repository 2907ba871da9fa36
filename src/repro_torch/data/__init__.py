"""Data substrate: Table-I graph builders."""
from .graphs import table1_graph, table1_features, scaled_dataset
