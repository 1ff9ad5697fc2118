"""Deterministic integer hashing used by the partitioner (numpy, build time).

The numpy half of `repro.core.hashing`, kept bit-identical so the port
builds the same partitions and routing tables as the JAX reference:
splitmix64 for the edge partitioners, a Murmur-style 32-bit mix for vertex
home partitions.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64
_U32 = np.uint32


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer; input any integer dtype, output uint64."""
    z = x.astype(np.int64).view(_U64) if x.dtype != _U64 else x.copy()
    with np.errstate(over="ignore"):
        z = (z + _U64(0x9E3779B97F4A7C15)) & _U64(0xFFFFFFFFFFFFFFFF)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z = z ^ (z >> _U64(31))
    return z


def hash_mod(x: np.ndarray, mod: int, salt: int = 0) -> np.ndarray:
    """Hash-then-mod used for edge placement (numpy, build time)."""
    h = splitmix64(np.asarray(x, dtype=np.int64) ^ np.int64(salt))
    return (h % _U64(mod)).astype(np.int64)


def mix32_np(x: np.ndarray) -> np.ndarray:
    """Murmur3-style 32-bit finalizer."""
    z = np.asarray(x).astype(np.int64).astype(np.uint32)  # two-step: wrap mod 2^32
    z = z ^ (z >> _U32(16))
    z = (z * _U32(0x85EBCA6B)) & _U32(0xFFFFFFFF)
    z = z ^ (z >> _U32(13))
    z = (z * _U32(0xC2B2AE35)) & _U32(0xFFFFFFFF)
    z = z ^ (z >> _U32(16))
    return z


def hash_mod32(x: np.ndarray, mod: int, salt: int = 0) -> np.ndarray:
    """Home-partition assignment of vertex ids (32-bit)."""
    x32 = np.asarray(x).astype(np.int64).astype(np.uint32).view(np.int32)
    return (mix32_np(x32 ^ np.int32(salt)) % _U32(mod)).astype(np.int64)
