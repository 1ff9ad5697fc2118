"""Engine: partitioning, exchange, view, mrTriplets, Pregel, collections,
joins, the chain planner, algorithms."""
from .collections import Col, shuffle_by_key
from .exchange import LocalExchange, with_wire
from .graph import Graph
from .pregel import PregelResult, pregel, pregel_fused
from .view import prune_view
from .analysis import union_read_dirs
from . import planner
from .planner import ChainPlan, ChainResult, plan_chain, run_chain

__all__ = ["ChainPlan", "ChainResult", "Col", "Graph", "LocalExchange",
           "PregelResult", "plan_chain", "planner", "pregel", "pregel_fused",
           "prune_view", "run_chain", "shuffle_by_key", "union_read_dirs",
           "with_wire"]
