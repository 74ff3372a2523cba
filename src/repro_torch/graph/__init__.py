from .csr import (CSRGraph, build_csr, degree_buckets, edge_list,
                  from_reference_arrays, padded_rows, to_numpy)
from .datasets import DATASETS, dataset_stats, get_dataset
from .generators import erdos_renyi, powerlaw_cluster, rmat

__all__ = [
    "CSRGraph", "build_csr", "degree_buckets", "edge_list",
    "from_reference_arrays", "padded_rows", "to_numpy",
    "DATASETS", "dataset_stats", "get_dataset",
    "erdos_renyi", "powerlaw_cluster", "rmat",
]
