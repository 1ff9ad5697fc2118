"""Engine: partitioning, exchange, view, mrTriplets, Pregel, algorithms."""
from .collections import Col
from .exchange import LocalExchange, with_wire
from .graph import Graph

__all__ = ["Col", "Graph", "LocalExchange", "with_wire"]
