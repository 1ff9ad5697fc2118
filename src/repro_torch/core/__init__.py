"""Engine: partitioning, exchange, view, mrTriplets, Pregel, algorithms."""
from .exchange import LocalExchange, with_wire
from .graph import Graph

__all__ = ["Graph", "LocalExchange", "with_wire"]
