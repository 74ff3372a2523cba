"""SVPU value plane (paper §IV-E, §VI-I): weighted pattern mining.

A weighted CSR carries one f32 per directed edge aligned with the key
storage (``graph.with_edge_values`` / ``padded_value_rows``); aggregate
plans stamp the count leaf with a value disposition
(``mining.plan.compile_pattern(..., aggregate=)``), and the engine's
aggregate leaf rides the same k-reference launch as the unweighted leaf
(``kernels.ops.xlevel_agg``). This package holds the per-(row, key) weight
lookups against CSR storage (``plane``).
"""
from .plane import edge_value_lookup, prefix_scale

__all__ = ["edge_value_lookup", "prefix_scale"]
