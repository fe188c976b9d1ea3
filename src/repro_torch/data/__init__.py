"""Data: synthetic training pipelines, query generators, road presets."""
from .pipelines import (lm_batches, recsys_batches, gnn_full_batch,
                        gnn_molecule_batch, NeighborSampler)
from .queries import grid_distance_queries

__all__ = ["lm_batches", "recsys_batches", "gnn_full_batch",
           "gnn_molecule_batch", "NeighborSampler",
           "grid_distance_queries"]
