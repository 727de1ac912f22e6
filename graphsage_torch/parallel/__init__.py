"""Parallel training over ``torch.distributed``: the counterpart of
``graphsage_tpu/parallel/``, one process per rank (NCCL on the card, gloo on
the CPU).

  multihost      — the process group (``torchrun``'s environment or a world
                   of one) and the rank's device
  mesh           — named device meshes (``data``, ``model``, ``graph``)
  partition      — contiguous CSR edge blocks
  distributed    — edge-partitioned full-graph aggregation and the DP+TP
                   ``ShardedTrainer``
  halo           — node partitions (the plan, orders, the auto levers,
                   ``locality_relabel``) and the halo-exchange full-graph
                   aggregation behind ``FullGraphTrainer(mesh=)`` and
                   ``ServingEngine(mesh=)``
  native_partition — the C++ LPA and BFS (``csrc/partitioner.cpp``)
  feature_store  — the node-sharded feature table (f32, bf16 or int8), its
                   dense and compact cross-rank gathers, the hub cache, the
                   layer-0 table build of ``layer0="full"`` (all-gather or
                   halo), ``ShardedFeatureTrainer`` (``--mode sharded``), the
                   sharded adjacency with its distributed sampler and
                   ``FullyShardedTrainer`` (``--mode fully-sharded``)
"""
