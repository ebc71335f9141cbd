"""Operator configuration enums.

Reference parity: operators/configs.hxx:31-92 (load_balance_t,
advance_io_type_t, advance_direction_t, filter_algorithm_t,
uniquify_algorithm_t). Load-balance variants are gone by construction (the
edge-centric layout is always balanced); what remains meaningful is the
combine monoid and the input kind.
"""

from __future__ import annotations

import enum


class Combine(str, enum.Enum):
    """Deterministic segment-combine monoid replacing the reference's
    user-side atomics (atomicMin/Max/Add relaxations)."""
    MIN = "min"
    MAX = "max"
    SUM = "sum"
    OR = "or"
    AND = "and"


class AdvanceIO(str, enum.Enum):
    """Reference parity: advance_io_type_t {graph, vertices, edges, none}."""
    GRAPH = "graph"        # all edges active (frontier ignored)
    VERTICES = "vertices"  # vertex boolmap frontier
    EDGES = "edges"        # edge boolmap frontier (CSR edge-id order)
    NONE = "none"          # no output frontier materialized
