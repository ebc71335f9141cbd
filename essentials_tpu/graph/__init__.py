"""Device graph: immutable pytree with CSR/CSC/COO views, padded static shapes.

Capability parity with reference include/gunrock/graph/ (graph_t multi-view
variadic class, builders, conversions, properties) re-designed for XLA:
instead of per-view template dispatch, one pytree carries edge-centric arrays
in both source-sorted (CSR) and destination-sorted (CSC) order so every
operator is a gather + sorted segment reduction with static shapes.
"""

from essentials_tpu.graph.graph import Graph, build_graph, GraphProperties
from essentials_tpu.graph.analytics import (
    average_degree, degree_standard_deviation, degree_histogram)

__all__ = [
    "Graph", "build_graph", "GraphProperties",
    "average_degree", "degree_standard_deviation", "degree_histogram",
]
