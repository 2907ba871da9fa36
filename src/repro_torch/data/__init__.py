"""Data substrate: Table-I graph builders and the synthetic token stream."""
from .graphs import table1_graph, table1_features, scaled_dataset
from .tokens import TokenStream, synthetic_batch
