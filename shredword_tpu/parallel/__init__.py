"""Data-parallel sharded BPE + Unigram training over a
jax.sharding.Mesh.

Greenfield component: the reference is strictly single-threaded
(SURVEY.md §2.D); corpus sharding + cross-shard count reduction replace
the absent NCCL/MPI layer with XLA collectives.
"""

from . import multihost, unigram
from .giant import sharded_giant_train
from .hist import sharded_hist_train
from .train import (ShardedCorpus, make_mesh, shard_corpus,
                    sharded_train, sharded_train_loop)

__all__ = ["ShardedCorpus", "make_mesh", "shard_corpus", "sharded_train",
           "sharded_train_loop", "sharded_hist_train",
           "sharded_giant_train", "multihost", "unigram"]
