"""Engine: partitioning, exchange, view, mrTriplets, Pregel, algorithms."""
from .collections import Col
from .exchange import LocalExchange, with_wire
from .graph import Graph
from .pregel import PregelResult, pregel, pregel_fused

__all__ = ["Col", "Graph", "LocalExchange", "PregelResult", "pregel",
           "pregel_fused", "with_wire"]
