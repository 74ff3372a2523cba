from .csr import (CSRGraph, build_csr, degree_buckets, edge_list,
                  from_reference_arrays, padded_rows, padded_value_rows, to_numpy,
                  with_edge_values)
from .datasets import DATASETS, dataset_stats, get_dataset
from .generators import edge_weights, erdos_renyi, powerlaw_cluster, rmat

__all__ = [
    "CSRGraph", "build_csr", "degree_buckets", "edge_list",
    "from_reference_arrays", "padded_rows", "padded_value_rows", "to_numpy",
    "with_edge_values", "DATASETS", "dataset_stats", "get_dataset",
    "edge_weights", "erdos_renyi", "powerlaw_cluster", "rmat",
]
