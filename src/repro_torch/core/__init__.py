"""Engine: partitioning, exchange, view, mrTriplets, Pregel, algorithms."""
from .exchange import LocalExchange
from .graph import Graph

__all__ = ["Graph", "LocalExchange"]
