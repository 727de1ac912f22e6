"""Parallel training over ``torch.distributed``: the counterpart of
``graphsage_tpu/parallel/``, one process per rank (NCCL on the card, gloo on
the CPU).

  multihost      — the process group (``torchrun``'s environment or a world
                   of one) and the rank's device
  mesh           — named device meshes (``data``, ``model``, ``graph``)
  partition      — contiguous CSR edge blocks
  distributed    — edge-partitioned full-graph aggregation and the DP+TP
                   ``ShardedTrainer``
  feature_store  — the node-sharded feature table, its dense and compact
                   cross-rank gathers, the hub cache, ``ShardedFeatureTrainer``
                   (``--mode sharded``), the sharded adjacency with its
                   distributed sampler and ``FullyShardedTrainer``
                   (``--mode fully-sharded``)
"""
