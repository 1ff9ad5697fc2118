"""Synthetic graph generators."""
from .graphs import GraphData, chain, rmat, star, symmetrize, table1

__all__ = ["GraphData", "chain", "rmat", "star", "symmetrize", "table1"]
