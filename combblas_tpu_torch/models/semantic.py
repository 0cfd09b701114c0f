"""Semantic (attributed-edge) graphs: the TwitterEdge / SemanticGraph
counterparts (port of ``combblas_tpu/models/semantic.py``).

The reference's ``TwitterEdge`` (``Applications/TwitterEdge.h:15``) carries
(count, follower, latest) per edge, and FilteredBFS (``FilteredBFS.cpp:129``)
traverses only the edges inside a time window.  Here the attributes pack
into one float32-exact code per edge, so the attributed graph is a plain
:class:`SpCOO` and every structural op applies to it unchanged; the
predicates decode the codes on the device.

Packing: code = follower + 2*count + 2*COUNT_LIM*time_bucket, plus 1 so
that no attribute is the structural zero; exact in float32 while it stays
below 2^24.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from combblas_tpu_torch.models.filtered import (
    bfs_filtered,
    bfs_filtered_dist,
    materialize_filtered,
)
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.parallel.dist import DistSpMat

__all__ = [
    "TwitterGraph",
    "pack_twitter",
    "unpack_twitter",
    "tweet_within_interval",
    "tweet_since",
    "is_follower",
]

_COUNT_LIM = 128          # the retweet count saturates here
_TIME_LIM = (1 << 24) // (2 * _COUNT_LIM)  # time buckets


def pack_twitter(follower, count, latest) -> np.ndarray:
    """Host: (follower, retweet count, latest time bucket) to float32-exact
    codes (``TwitterEdge(mycount, myfollow, mylatest)``,
    ``TwitterEdge.h:22``)."""
    follower = np.asarray(follower).astype(np.int64)
    count = np.minimum(np.asarray(count).astype(np.int64), _COUNT_LIM - 1)
    latest = np.asarray(latest).astype(np.int64)
    if not ((latest < _TIME_LIM).all() and (latest >= 0).all()):
        raise ValueError("time bucket out of range; rescale the timestamps")
    return (follower + 2 * count + 2 * _COUNT_LIM * latest + 1).astype(
        np.float32)


def unpack_twitter(code: torch.Tensor):
    """Inverse of :func:`pack_twitter` on the device: (follower, count,
    latest), zeros where the code is 0 (no edge).  ``%`` and ``//`` floor,
    as JAX's do, on the absent codes' -1."""
    c = code.to(torch.int32) - 1
    present = code != 0
    follower = ((c & 1) > 0) & present
    count = torch.where(present, (c >> 1) % _COUNT_LIM, 0)
    latest = torch.where(present, c // (2 * _COUNT_LIM), 0)
    return follower, count, latest


def is_follower(code: torch.Tensor) -> torch.Tensor:
    """``TwitterEdge::isFollower`` (``TwitterEdge.h:23``)."""
    return unpack_twitter(code)[0]


def tweet_since(begin: int) -> Callable:
    """The ``TweetSince`` predicate (``TwitterEdge.h:26``)."""

    def pred(code):
        _, cnt, latest = unpack_twitter(code)
        return (cnt > 0) & (latest >= begin)

    return pred


def tweet_within_interval(begin: int, end: int) -> Callable:
    """The ``TweetWithinInterval`` predicate (``TwitterEdge.h:25``), the
    FilteredBFS time window (``FilteredBFS.cpp:259``)."""

    def pred(code):
        _, cnt, latest = unpack_twitter(code)
        return (cnt > 0) & (latest >= begin) & (latest <= end)

    return pred


@dataclasses.dataclass(frozen=True)
class TwitterGraph:
    """A SemanticGraph over Twitter-style edges: an :class:`SpCOO` whose
    values are packed attribute codes."""

    mat: SpCOO

    @staticmethod
    def build(src, dst, follower, count, latest, n: int,
              device=None) -> "TwitterGraph":
        """From host edge arrays, on ``device`` (the card when None);
        duplicate edges are kept, not summed."""
        codes = pack_twitter(follower, count, latest)
        return TwitterGraph(SpCOO.from_arrays(src, dst, codes, (n, n),
                                              sum_duplicates=False,
                                              device=device))

    def bfs_within(self, root: int, begin: int, end: int):
        """Filtered BFS over the retweet edges inside [begin, end] (the
        FilteredBFS main loop, ``FilteredBFS.cpp:129``)."""
        return bfs_filtered(self.mat, root, tweet_within_interval(begin, end))

    def subgraph_within(self, begin: int, end: int) -> SpCOO:
        """The materialized semantic subgraph (repeated-query path)."""
        return materialize_filtered(self.mat,
                                    tweet_within_interval(begin, end))

    def distribute(self, grid) -> DistSpMat:
        """The graph on a block grid, the packed codes as values."""
        return DistSpMat.from_local(self.mat, grid)

    def bfs_within_dist(self, grid_or_mat, root: int, begin: int, end: int):
        """Distributed filtered BFS (``FilteredBFS.cpp:129`` on the grid)
        on a grid (the graph distributed first) or a distributed copy."""
        mat = (grid_or_mat if isinstance(grid_or_mat, DistSpMat)
               else self.distribute(grid_or_mat))
        return bfs_filtered_dist(mat, root, tweet_within_interval(begin, end))
