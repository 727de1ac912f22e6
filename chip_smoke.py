#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``graphsage_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure ends the run with a non-zero exit code and no
``ok`` line):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: compile the CUDA kernels from ``graphsage_torch/csrc``.
3. data: synthetic Cora files at full size (2708 x 1433) through
   ``load_cora``, the synthetic Pubmed graph (19717 x 500), synthetic
   Pubmed files for training, and a heavy-tailed Pubmed-sized stand-in
   (``power_law_graph``: 19717 x 500, 44338 edges, degrees up to the
   hundreds) on which hop 1's fanout of 25 is really sampled.
4. kernel checks: each kernel against its plain PyTorch version at the
   serving and training shapes (f32 and bf16, all-masked rows, repeated ids,
   masked slots holding out-of-range ids, k = 25 and 40 slots per row, a
   zero-degree CSR row, a star whose centre row holds 5000 edges), and the
   SpMM backward against the plain version's autograd, symmetric and
   directed; ``rtol=atol=1e-5`` (a bf16 gradient: one bf16 rounding step;
   a plain sum, as the unnormalised SpMM and its backward give: ``rtol``
   of the sum of its terms' magnitudes, since hub rows sum thousands). The
   gather-mean, SpMM and DMA gather-mean kernels sum in a fixed order: a
   second launch must be bitwise equal to the first. Kernels 2 and 4 also at
   the edges of their launch geometry (``redesign_cases``).
5. timings: device time per call (profiler) on each graph's sampled
   frontier (both gather-means also over the raw features, as layer 0
   reads them when it aggregates first; the SpMM also unnormalised over
   the raw features, the layer-0 cache's build), beside the plain version,
   one PyTorch library call computing the same function (the scatter's:
   ``torch.zeros`` then ``index_add_``), and the bound (the bytes the call
   must move over 3.35 TB/s, or its operations over 67 TFLOP/s f32,
   whichever is larger; bytes count only the rows and ids that this
   frontier's valid slots need); per-call time through the wrapper (CUDA
   events). Kernel 2's device time by kernel name (zero fill against
   scatter).
6. serving: the ``cora`` and ``pubmed`` presets at full width, random
   weights from a seeded generator, through the table tier and the sampled
   tier, and the ``pubmed`` preset again on the heavy-tailed stand-in (its
   refresh runs the SpMM over a row of 949 edges); launch counters are set
   to 0 just before each tier and read just after. Checks: finite logits,
   identical answers to a repeated request, sampled == table at covering
   fanouts (on the stand-in for an 8-node request: covering fanouts of 949
   grow each hop 949-fold), the card's forward == the CPU forward on one
   frontier. A warm table refresh is timed (host and device ms).
7. training: ``run_preset("cora")`` (100 steps) and ``run_preset("pubmed")``
   (200 steps) at full width, counters set to 0 just before and read just
   after: the gather-mean and scatter-mean kernels launch once per step;
   finite losses, the last below 0.7x the first, validation micro-F1 above
   0.5. Host and device time per step, and the device's idle share. Then
   Cora for 20 steps with ``gather_impl="dma"``: its kernel launches on
   every step and its losses match the default route's (``rtol=1e-4``: the
   scatter's atomics sum in another order). Then the Pubmed preset on the
   heavy-tailed stand-in (200 steps, lr 0.1), with the same checks. Then
   the card's parameter gradients against the CPU's, on freshly initialised
   models (large gradients), for one sampled step on each graph and for the
   full-graph loss over Cora's train split: each leaf within 1e-4 of its own
   largest entry (the SpMM kernel must launch in the full-graph backward).
   Then one step on each graph timed with ``project_first`` on and off.
8. layer-0 cache: ``with_cached_layer0`` on the card (kernel 3, one launch
   each) against the plain build on the CPU, on the three graphs with a
   zero-degree row appended, both flavors; the build on the synthetic
   Pubmed graph timed (host and device ms).
9. the layer-0 modes and the other aggregators: ``run_preset`` of
   ``pubmed_layer0_full`` (200 steps: kernel 3 launches twice per step,
   forward and backward, kernels 1 and 2 never), again on the heavy-tailed
   stand-in at lr 0.1, ``pubmed_layer0_cached`` (the cache built once, at
   construction: one launch of kernel 3; its steps launch no kernel),
   ``cora_pool`` and ``cora_lstm`` (100 steps each, no kernel in a step;
   ``cora_pool``'s full-graph evaluation launches the segment max once per
   layer), counters set to 0 just before each and read just after; the learning bar, host and
   device ms per step and the idle share. Card-against-CPU gradients of
   fresh ``pubmed_layer0_full`` (kernel 3 in the backward), ``cora_pool`` and
   ``cora_lstm`` models. Serving a ``pubmed_layer0_full`` and a
   ``cora_pool`` model through both tiers (``cora_pool``'s table tier
   launches the segment max), sampled == table at covering fanouts. One line per Pubmed-sized graph with the step times of the
   three layer-0 modes (``pubmed``, ``pubmed_layer0_full``,
   ``pubmed_layer0_cached``) on that graph, and the device time of
   ``pubmed_layer0_full``'s table gather by indexing against ``gather``.
10. reduced precision: the ``reddit``, ``powerlaw`` and ``powerlaw_1m``
   datasets (``load_dataset``: seeded ``power_law_graph`` stand-ins of 232965,
   100000 and 10^6 nodes) and an int8 copy of the 1M-node graph; the new
   kernel routes against their plain versions and a second launch of
   themselves (kernel 3 on bf16 rows at F=128, 256 and 602 and its backward,
   kernel 4 on bf16 at F=128 and 602, kernel 1 on int8 at F=256 and 602 with
   a zero-scale row and an all-masked row; bf16 results within one bf16 step,
   ``BF16_TOL``); their timings at the presets' shapes (library calls on the
   route's dtype where the library takes it, else on the f32 table; kernel 3's
   cache build with a second bound, one row read per edge); training
   ``reddit`` (100 steps), ``powerlaw`` (50, through ``run_preset``),
   ``powerlaw_1m``, ``powerlaw_1m_layer0_cached`` and ``powerlaw_1m`` over
   the int8 table (30 each, the 1M-node graph built once), each against its
   learning floor (``FLOORS``) with launches per step, host and device ms and
   the kernel instance the step ran; ``reddit`` for 20 steps on the ``dma``
   route (kernel 4 on bf16 rows; its losses match the default route's);
   card-against-CPU gradients of fresh
   bf16 models within 2e-2 of each leaf's largest entry; serving ``reddit``
   through both tiers and a bf16 ``powerlaw`` model through the table tier
   with and without ``quantize_table``; the two layer-0 orders at ``reddit``.
11. samplers, full-batch training, the multilabel head: ``powerlaw_1m``
   and ``powerlaw_1m_layer0_cached`` with ``sampling="windowed"`` (30 steps
   each on the graphs of the Floyd runs, the cached one with its cache;
   the 0.8 floor; beside the Floyd runs' host and device ms, idle share and
   kernel 1's launches); the sampling stage's device ms by method (one hop
   of fanout 15 over 4096 seeds and the preset's three-hop frontier; ``topk``
   only on a graph whose ELL covers every row). ``FullGraphTrainer`` on
   ``bench.py``'s ``fullbatch`` configuration (40 steps, floor 0.8), on the
   ``pubmed`` preset through ``run_preset(mode="full-graph")`` and on
   ``reddit`` at full graph (100 steps; last loss below 0.7x the first,
   validation micro-F1 above 0.5): kernel 3 once per layer in the forward
   and once per layer whose input needs a gradient in the backward, every
   step; host and device ms per step and the idle share. One full-batch
   step's card gradients against the CPU's (kernel 3). Kernel 3 timed
   forward and backward (on ``g / deg``) at the ``fullbatch`` and
   ``reddit`` full-graph layer-0 shapes beside ``torch.sparse.mm``, and at
   the published Reddit model's f32 rows ([232965, 128] over a graph of
   Reddit's size and degree, drawn on the card), with the column panels each shape takes
   (``ops/spmm.py:panels``; 1 at Pubmed, printed with every kernel-3 row)
   and its rows against the plain version on the first 4000. The PPI protocol at the
   paper's shape (24 graphs of 2372 nodes, 121 labels): train on the union
   of 20, sampled and full-batch, each over the bars of
   ``tests/test_multilabel.py`` on the 4 held out; one held-out graph
   served through the table tier with the trainer's multi-hot predictions.
   Then the segment max at the ``reddit-pool`` cell's shape (pooled rows
   [232965, 512] f32 over a Reddit-sized graph drawn on the card, with full
   ties, ties at 0 and above it planted): the forward in the planner's
   panels bitwise equal to one pass and, on the first 1000 rows, to the
   plain version, with ``agg.segment_max.panels`` counted; the backward
   through both routes against the plain one (``TOL`` of the terms'
   magnitude); device ms and per call of each beside the bound. This shape
   is the segment max's row on the kernels line.
12. unsupervised training, checkpoints, inductive serving: ``run_preset`` of
   ``cora_unsup`` at full width (150 steps of 3072 group seeds: kernels 1
   and 2 once per step, kernel 3 once per layer in the probe's evaluation)
   against the bars of ``tests/test_unsupervised.py`` (the last 10 losses'
   mean below the first 10's minus 0.3, mean embedding norm above 0.05,
   edge endpoints' cosine above random pairs' + 0.2, probe micro-F1 above
   1 / C + 0.2, the head bitwise unchanged), with host and device ms per
   step, the idle share and one probe's host ms; ``utils/memory`` on the
   card (the live total at least the graph's bytes, the largest block at
   least its table's); card against CPU gradients of the graph-context loss
   (an isolated seed among the groups; the head has none); kernels 1 and 2
   timed at ``cora_unsup``'s frontier; ``cora`` 100 steps straight (a
   snapshot every 25) against 50, a checkpoint and 50 resumed (losses and
   parameters within ``RESUME_RTOL``), the CLI's ``--eval-only`` giving the
   trained run's validation F1; the ``cora`` model trained on the subgraph
   induced by the first 70% of the heavy-tailed stand-in and served on the
   full graph's other 30% (table tier), micro-F1 above 1 / C + 0.55.
13. parallel: a world of one over NCCL (``multihost.initialize`` on
   127.0.0.1 and a free port); ``ShardedFeatureTrainer`` trains ``cora``,
   ``pubmed`` and ``pubmed_layer0_cached`` at their presets for 40 steps
   each, counters set to 0 just before and read just after (kernels 1 and 2
   in their sum modes once per step, kernel 1's once more in the sampled
   evaluation; the cached run reads its cache shard through kernel 1's sum
   mode, scatters nothing, and builds the cache on the card with kernel 3
   once, at construction), step for step
   against the single-device ``Trainer`` from the same seed (``RESUME_RTOL``)
   and over the learning bar, with host and device ms per step beside the
   single-device step's, NCCL's device ms and ``memory_stats()``;
   ``distributed_full_graph_logits`` (mean: kernel 3 once per layer over
   the rank's edge block; maxpool) against ``forward_full_graph`` on the
   heavy-tailed stand-in; ``ShardedTrainer`` on a ``{"data": 1, "model":
   1}`` mesh against ``Trainer`` for 5 Pubmed steps. Then two ranks of this
   script (``--two-rank``) share the card over gloo (NCCL refuses two ranks
   on one device) and train ``cora`` node-sharded over S = 2, each rank
   within ``RESUME_RTOL`` of the single-device run. The sum modes of kernels
   1 and 2 are also checked (phase 4: f32 and bf16 tables, colliding
   atomics, a second launch bitwise equal) and timed (phase 5) at each
   frontier.
14. the compact exchange, the hub cache, the fully sharded trainers, in the
   world of one over NCCL (after phase 13's node-sharded runs): kernels 1 and
   2 (mean modes) at the compact answer-buffer shapes of ``cora`` and
   ``pubmed`` against their plain versions (kernel 1 also against the direct
   gather-mean) and timed; ``ShardedFeatureTrainer(gather_mode="compact")``
   at ``cora`` and ``pubmed`` (40 steps: kernel 1's mean mode over the
   answer buffer once per step and evaluation, kernel 2's mean mode into the
   buffer's gradient and its sum mode into the shard's once per step) within
   ``RESUME_RTOL`` of the single-device run, with the largest relative gaps
   to it and to the dense run, host and device ms, the collectives' share,
   launches by mode and ``sharded_comm_stats``; the retry ladder (``cora`` at
   ``capacity_slack=0.25``: two warnings a step, then applied, losses equal
   the compact run's; its host and device ms); the hub cache
   (``pubmed_layer0_cached`` on the stand-in with and without 256 hub rows,
   losses within ``HUB_RTOL``, ``hub_request_fraction``);
   ``FullyShardedTrainer`` at ``cora``, ``pubmed`` and
   ``pubmed_layer0_cached`` (5 steps at covering fanouts equal to the
   node-sharded run's, 40 at the preset's over the learning bar,
   ``memory_stats``); ``cora_unsup`` (150 steps) under
   ``UnsupervisedShardedTrainer`` (compact) and
   ``UnsupervisedFullyShardedTrainer`` against the bars of ``PERF.md`` §2;
   the CLI once (``--mode fully-sharded --steps 20``, which ends the process
   group). The two-rank phase (13) runs ``FullyShardedTrainer`` first (each
   rank's measured allocator blocks of its graph arrays below the whole
   arrays', its largest live block below the whole table's), then the dense
   and compact ``ShardedFeatureTrainer`` (within ``RESUME_RTOL`` of one
   device), at ``cora``, 20 steps each.
15. the halo exchange: a world of one over NCCL again (the CLI ended
   phase 14's); the native partitioner (built from ``csrc/partitioner.cpp``
   with ``g++``; the run fails without it) equal to numpy's LPA and BFS on
   the stand-in and timed against them (host ms), and alone at ``reddit``;
   ``FullGraphTrainer(mesh=)`` on ``pubmed`` (200 steps, the trainer's
   ``order="auto"`` plan), the stand-in at lr 0.1 with a hub threshold (100
   steps: the hub all-gather runs), ``reddit`` bf16 (100 steps, its plan in
   input order) and ``cora_pool`` (100 steps), counters set to 0 just before
   each and read just after (kernel 3 once per mean layer forward, over the
   combined CSR, and once per layer whose SpMM input needs a gradient,
   over its transpose; kernel 2's sum mode once per such exchange), each
   within ``HALO_RTOL`` of the single-device ``FullGraphTrainer`` step for
   step (``reddit``: ``HALO_BF16_RTOL``), with host and device ms beside it
   and ``comm_stats``; kernel 3 on
   the halo's combined CSR and its transpose and kernel 2's sum mode on a
   send list against their plain versions and timed (rank 0 of a 2-shard
   plan of the synthetic Pubmed graph and of the stand-in; ``reddit``'s
   world-of-one shard); ``ServingEngine(mesh=)`` serving ``pubmed`` and
   ``reddit`` against the single-device table tier, with ``memory_stats``.
   Then two ranks of this script (``--halo-two-rank``) share the card over
   gloo on the stand-in, ``order="auto"`` and ``"bfs"`` per offset with
   hubs: halo logits against ``forward_full_graph``, 20 steps within
   ``HALO_RTOL`` of one device, ``comm_stats`` against
   ``partition_comm_rows``.
16. the rest of the sharded modes: kernel 3 at the node-sharded layer-0
   table's shapes (the synthetic Pubmed graph's rank CSR over a projected
   ``[S * Np, 128]`` buffer at S = 1 and rank 0 of 2, forward and its
   transpose) and kernel 1's int8 route over the compact answer buffer
   (Pubmed's table quantized, ``powerlaw_1m``'s int8 table), each against
   its plain version and a second launch of itself and timed; in a world
   of one over NCCL again, ``pubmed_layer0_full`` node-sharded for
   ``MODES_STEPS`` steps (the all-gather build with dense and compact
   gathers, the halo build with dense ones: kernel 3 twice a step, its
   transpose in the backward) within ``MODES_RTOL`` of the single-device
   ``Trainer`` step for step, and ``FullyShardedTrainer`` at covering
   fanouts against ``ShardedFeatureTrainer`` for 5 steps; ``powerlaw_1m``
   over the int8 table node-sharded (dense: kernel 1's int8 sum mode on the
   owner side; compact with 256 hub rows: its int8 route over the int8
   answer buffer) and ``powerlaw_1m_layer0_cached`` over an int8 cache,
   the preset's 30 steps within ``MODES_BF16_RTOL`` of one device's;
   ``ShardedTrainer`` on ``{"data": 1, "model": 1}`` for
   ``pubmed_layer0_full``, ``cora_lstm`` and ``powerlaw_1m`` int8 against
   ``Trainer``; ``sharded_comm_stats`` at S = 8 (``pubmed_layer0_full``
   with its halo plan; ``reddit``'s raw rows in bf16 and int8). Each run
   prints host and device ms per step, the idle share, the top kernels and
   its launches, counters set to 0 just before and read just after. Then
   two ranks of this script (``--modes-two-rank``) share the card over
   gloo: ``pubmed_layer0_full`` with the all-gather and the halo builds and
   ``cora`` over an int8 table (compact) and over its dense twin, 20 steps
   each within ``MODES_TWO_RANK_RTOL`` of one device (``cora`` int8:
   ``MODES_INT8_TWO_RANK_RTOL``).
17. ingestion: the native loader (built from ``csrc/graph_loader.cpp`` with
   ``g++`` in phase 2, its build time printed there; the run fails without
   it): its eager parses of the synthetic Cora and Pubmed files equal the
   Python engine's bitwise, ``build_csr_native`` equals
   ``sorted_unique_edges``, and host ms of the Python and native eager
   parses, the lazy index pass and all rows through each row loader at
   Pubmed size. In a world of one over NCCL again: lazy ``cora`` and
   ``pubmed`` (native rows) through ``shard_features_from_loader`` and
   ``ShardedFeatureTrainer(feature_store=)``, dense and compact, 40 steps
   each within ``INGEST_RTOL`` of phases 13 and 14's eager runs step for
   step; ``FullyShardedTrainer(feature_store=)`` at ``cora`` against phase
   14's and ``pubmed_layer0_full`` from the lazy Pubmed against phase 16's
   (kernel 3 over the store's slice); the int8 loader store bitwise the
   eager ``quantize_graph`` store and ``cora`` on each (kernel 1's int8
   route); host and device ms per step beside the eager runs', the feature
   bytes per rank and ``max_memory_allocated`` across each store's build;
   the descriptor guards (``to("cuda")``, ``Trainer``, ``ServingEngine``)
   and their text; ``pubmed_layer0_cached``'s cache built on the CPU in
   blocks of ``INGEST_EDGE_BLOCK`` edges against the card's kernel-3 build
   (``1e-6``), with its host ms and peak traced transient; the port's eight
   examples, each once with few steps (its last line printed). Every
   kernel mode of the path (kernel 1 sum and mean, kernel 2 sum and mean,
   kernel 3) must have launched. Then two ranks of this script
   (``--ingest-two-rank``) share the card over gloo: each rank's loader is
   asked for its own rows only, and 20 losses are within ``INGEST_RTOL``
   of one device.
18. a ``{"kernels": [...]}`` line (the sum modes, the compact answer-buffer
   mean modes, the halo path's kernels 3 and 2, kernel 3 on the node-sharded
   layer-0 table and kernel 1's int8 route over the compact answer buffer
   as their own entries), then the last line ``{"ok": true, "device":
   {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F

import graphsage_torch.ops.gather_dma as dma_kernel
import graphsage_torch.ops.gather_mean as gm_kernel
import graphsage_torch.ops.scatter_mean as sm_kernel
import graphsage_torch.ops.segment_max as smax_kernel
import graphsage_torch.ops.spmm as spmm_kernel
from graphsage_torch import (
    PRESETS,
    FullGraphTrainer,
    GraphSAGE,
    ServingEngine,
    TrainConfig,
    build_graph,
    disjoint_union,
    induced_subgraph,
    load_cora,
    run_preset,
)
from graphsage_torch.data import native
from graphsage_torch.data.graph import quantize_graph, sorted_unique_edges, with_cached_layer0
from graphsage_torch.data.loaders import load_cora_lazy, load_pubmed_lazy
from graphsage_torch.data.synthetic import (
    power_law_graph,
    synth_cora_files,
    synth_pubmed_files,
    synthetic_ppi_graphs,
    synthetic_pubmed_graph,
)
from graphsage_torch.ops import _build
from graphsage_torch.ops import quantize as tq
from graphsage_torch.ops.aggregate import gather
from graphsage_torch.ops.sampling import sample_neighbors
from graphsage_torch.models.unsupervised import context_groups, frontier_loss
from graphsage_torch.ops.walks import negative_cdf
from graphsage_torch.parallel import multihost
from graphsage_torch.parallel.distributed import (
    ShardedTrainer,
    distributed_full_graph_logits,
    edge_block,
)
from graphsage_torch.parallel.feature_store import (
    FullyShardedTrainer,
    ShardedFeatureTrainer,
    hub_request_fraction,
    request_capacity,
    route_buckets,
    shard_features,
    shard_features_from_loader,
    sharded_comm_stats,
)
from graphsage_torch.parallel import feature_store as fs
from graphsage_torch.parallel import halo, native_partition
from graphsage_torch.parallel.halo import (
    auto_partition_plan,
    build_node_partition,
    halo_full_graph_logits,
    partition_comm_rows,
)
from graphsage_torch.parallel.mesh import make_mesh
from graphsage_torch.parallel.partition import partition_edges
from graphsage_torch.train.experiments import build_model, load_dataset, preset_config
from graphsage_torch.train.experiments import main as train_main
from graphsage_torch.train.trainer import Trainer
from graphsage_torch.train.unsupervised import (
    UnsupervisedFullyShardedTrainer,
    UnsupervisedShardedTrainer,
)
from graphsage_torch.utils import memory, profiling
from graphsage_torch.utils.checkpoint import restore_checkpoint
from graphsage_torch.utils.metrics import micro_f1

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 outside the tensor cores.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The kernels and their plain versions sum in different orders (the scatter
# with atomics, in an order that changes from run to run).
TOL = dict(rtol=1e-5, atol=1e-5)
# A bf16 gradient is an f32 sum rounded once to bf16: sums taken in another
# order may round to the neighbouring bf16 value, one step of 2**-7 relative.
BF16_GRAD_TOL = dict(rtol=2.0**-7, atol=1e-5)
# Training runs that differ only in the order of the scatter's sums.
LOSS_RTOL = 1e-4
# Card against CPU gradients: f32 products and sums in other orders; each
# leaf is held to this fraction of its own largest entry.
GRAD_RTOL = 1e-4
# The preset each graph trains and serves with. The heavy-tailed stand-in
# trains at lr 0.1, as the JAX package's power-law presets do: at the Pubmed
# preset's 0.7 the loss diverges on its unit-scale Gaussian features.
PRESET_OF = {"cora": "cora", "pubmed": "pubmed", "pubmed heavy-tailed": "pubmed",
             "pubmed_layer0_full": "pubmed_layer0_full",
             "pubmed_layer0_full heavy-tailed": "pubmed_layer0_full",
             "pubmed_layer0_cached": "pubmed_layer0_cached",
             "cora_pool": "cora_pool", "cora_lstm": "cora_lstm", "reddit": "reddit"}
OVERRIDES_OF = {"pubmed heavy-tailed": {"learning_rate": 0.1},
                "pubmed_layer0_full heavy-tailed": {"learning_rate": 0.1}}
# The Pubmed preset in each layer-0 mode.
LAYER0_PRESETS = {"sampled": "pubmed", "full": "pubmed_layer0_full",
                  "cached": "pubmed_layer0_cached"}
KERNELS = {
    "gather_mean": dict(
        route="cuda",
        source="graphsage_torch/csrc/gather_mean.cu",
        replaces="graphsage_tpu/ops/pallas_onehot.py:45",
        module=gm_kernel,
    ),
    "spmm_mean": dict(
        route="cuda",
        source="graphsage_torch/csrc/spmm_mean.cu",
        replaces="graphsage_tpu/ops/pallas_spmm.py:84",
        module=spmm_kernel,
    ),
    "scatter_mean": dict(
        route="cuda",
        source="graphsage_torch/csrc/scatter_mean.cu",
        replaces="graphsage_tpu/ops/pallas_onehot.py:127",
        module=sm_kernel,
    ),
    "gather_mean_dma": dict(
        route="cuda",
        source="graphsage_torch/csrc/gather_mean_dma.cu",
        replaces="graphsage_tpu/ops/pallas_gather.py:39",
        module=dma_kernel,
    ),
    # The sum modes (normalize=False) of kernels 1 and 2: the node-sharded
    # feature store's owner side. Their launches are counted apart.
    "gather_mean_sum": dict(
        route="cuda",
        source="graphsage_torch/csrc/gather_mean.cu",
        replaces="graphsage_tpu/ops/pallas_onehot.py:45",
        module=gm_kernel,
        counter="sum_launches",
    ),
    "scatter_mean_sum": dict(
        route="cuda",
        source="graphsage_torch/csrc/scatter_mean.cu",
        replaces="graphsage_tpu/ops/pallas_onehot.py:127",
        module=sm_kernel,
        counter="sum_launches",
    ),
    # Port-only: the JAX package's full-graph max is an XLA scatter-max. Its
    # kernels line reads the reddit-pool cell's shape ("head"), not Pubmed's.
    "segment_max": dict(
        route="cuda",
        source="graphsage_torch/csrc/segment_max.cu",
        replaces="none (graphsage_tpu/ops/aggregate.py:239 segment_max_csr, XLA)",
        module=smax_kernel,
        head="reddit-pool cell forward",
    ),
}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"   {name} done in {time.perf_counter() - t0:.1f} s", flush=True)


def reset_launches() -> None:
    for k in KERNELS.values():
        setattr(k["module"], k.get("counter", "launches"), 0)


def read_launches() -> dict:
    return {name: getattr(k["module"], k.get("counter", "launches"))
            for name, k in KERNELS.items()}


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call of ``fn`` over ``iters`` back-to-back calls, between two
    CUDA events: the host's launch overhead counts where it starves the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20, attempts: int = 3) -> dict:
    """Device time per call of ``fn``, by kernel name, from CUPTI through
    ``torch.profiler`` (idle gaps between kernels do not count).

    Now and then a session records no device activity at all, and a second
    session started at once can come back empty too, so an empty session is
    repeated after a pause of a second, ``attempts`` times at most."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        if attempt:
            print(f"   (the profiler saw no device time; attempt {attempt + 1})")
            time.sleep(1.0)
        with warnings.catch_warnings():  # "profiler clears events at the end of each cycle"
            warnings.simplefilter("ignore", UserWarning)
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total / iters / 1e3
                   for e in prof.key_averages() if e.self_device_time_total > 0}
        if by_name:
            return by_name
    raise RuntimeError(f"the profiler saw no device time in {attempts} sessions")


def device_ms(fn, kernel: str | None = None, iters: int = 20) -> float:
    """Summed device time per call of every kernel ``fn`` launches; with
    ``kernel``, also check that a kernel of that name ran."""
    by_name = device_profile(fn, iters=iters)
    if kernel is not None and not any(kernel in name for name in by_name):
        raise AssertionError(f"no {kernel} among the kernels run: {list(by_name)}")
    return sum(by_name.values())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spmm_panels(x: torch.Tensor) -> int:
    """The column panels kernel 3 walks over table ``x`` on this card."""
    return spmm_kernel.panels(x.shape[0], x.shape[1], x.element_size(),
                              spmm_kernel.l2_bytes(x.device.index),
                              x.data_ptr() % spmm_kernel.LINE == 0)[0]


def max_err(got: torch.Tensor, want: torch.Tensor, what: str, tol=TOL,
            magnitude: torch.Tensor | None = None) -> float:
    """Largest |got - want|, after checking it against ``tol``. A sum of
    many f32 terms (a CSR row of a hub, hundreds long) rounds in proportion
    to its partial sums, not to its result: given ``magnitude``, the sum of
    the terms' absolute values for each element, each element is held to
    ``atol + rtol * magnitude`` instead."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if magnitude is None:
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{what}: {m}")
    else:
        excess = diff - (tol["atol"] + tol["rtol"] * magnitude)
        if not bool((excess <= 0).all()):
            i = int(excess.argmax())
            raise AssertionError(
                f"{what}: |got - want| {float(diff.flatten()[i]):.3g} above "
                f"{tol} of the terms' magnitude {float(magnitude.flatten()[i]):.3g}")
    return float(diff.max())


# ----------------------------------------------------------------- inputs
def gather_case(n, f, b, k, seed, dev):
    """Random table and frontier with all-masked rows and garbage ids in
    masked slots (the kernel must never read them)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32)).to(dev)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.8
    mask[:7] = False
    idx[~mask] = rng.choice([-7, n, 2**30], size=int((~mask).sum()))
    return x, torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)


def check_repeat(got: torch.Tensor, again, what: str) -> None:
    """The kernels sum in a fixed order: a second launch is bitwise equal."""
    if not torch.equal(got, again()):
        raise AssertionError(f"{what}: two launches differ")


def redesign_cases(dev):
    """Kernels 2 and 4 at the edges of their redesigns: ``(label, table,
    cotangent, idx, mask)`` with B not a multiple of the rows per warp, 25,
    40 and 200 slots per row (above 32: 32 slots at a time), 40000 rows of
    100 slots, 64 rows whose first 10 slots name the last id,
    a full row between empty ones, F not a multiple of 4, an unaligned table
    and cotangent (views one or three elements in), and F=1433 tables whose
    last row's 16-byte envelope ends past the table (N=2709) or with it
    (N=2708)."""
    shapes = [("3 rows per warp, B=24577", 19717, 128, 24577, 10, 0),
              ("k=25", 19717, 128, 2560, 25, 0), ("k=40", 2708, 128, 2560, 40, 0),
              ("k=200", 2708, 128, 2560, 200, 0), ("k=100, B=40000", 2708, 16, 40000, 100, 0),
              ("F=45", 2708, 45, 2560, 10, 0), ("F=1433 N=2709", 2709, 1433, 2560, 10, 0),
              ("F=1433 N=2708", 2708, 1433, 2560, 25, 0),
              ("unaligned F=128", 2708, 128, 2560, 10, 1),
              ("unaligned F=1433", 2708, 1433, 2560, 10, 3)]
    for i, (label, n, f, b, k, offset) in enumerate(shapes):
        x, idx, mask = gather_case(n, f, b, k, seed=500 + i, dev=dev)
        mask[9:12] = torch.tensor([False, True, False], device=dev)[:, None]
        idx[10] = torch.arange(k, device=dev) % n
        idx[20:84, :10], mask[20:84, :10] = n - 1, True
        idx[84] = 0
        g = torch.randn(b, f, generator=torch.Generator().manual_seed(i)).to(dev)
        if offset:
            x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(n, f)
            g = torch.cat([g.new_zeros(offset), g.flatten()])[offset:].view(b, f)
        yield label, x, g, idx, mask


def star_csr(leaves: int, dev):
    """Undirected star CSR: row 0 holds ``leaves`` edges, each leaf one edge
    back to 0, and one zero-degree row at the end."""
    indptr = np.concatenate([[0], leaves + np.arange(leaves + 1), [2 * leaves]])
    edge_dst = np.concatenate([np.arange(1, leaves + 1), np.zeros(leaves)])
    return (torch.from_numpy(indptr.astype(np.int32)).to(dev),
            torch.from_numpy(edge_dst.astype(np.int32)).to(dev))


def with_isolated_row(graph):
    """The graph's CSR with one zero-degree row appended."""
    indptr = torch.cat([graph.indptr, graph.indptr[-1:]]).contiguous()
    return indptr, graph.edge_dst


def frontier_inputs(model, graph, batch, seed):
    """Layer 0's gather-mean inputs on the sampled serving path for one
    ``batch``-node request (the projected table and the deepest hop)."""
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    seeds = torch.randint(0, graph.num_nodes, (batch,), generator=gen,
                          device=graph.device, dtype=torch.int32)
    fr = model.sample(gen, graph, seeds)
    n_out = fr.ids[1].numel()
    with torch.no_grad():
        table = graph.features @ model.layers[0].weight
    return (table.contiguous(), fr.ids[2].reshape(n_out, -1).contiguous(),
            fr.masks[2].reshape(n_out, -1).contiguous())


# ----------------------------------------------------------------- phases
def check_kernels(graphs) -> dict:
    dev = graphs["cora"].device
    errs = {name: 0.0 for name in KERNELS}
    # (the scatter's training shapes are the first two: N, F=128, B, k=10)
    shapes = [("cora", 2708, 128, 2560), ("pubmed", 19717, 128, 25600),
              ("cora mean-first", 2708, 1433, 2560),
              ("pubmed mean-first", 19717, 500, 25600)]
    for i, (label, n, f, b) in enumerate(shapes):
        x, idx, mask = gather_case(n, f, b, 10, seed=100 + i, dev=dev)
        want = gm_kernel.gather_mean_plain(x, idx, mask)
        got = gm_kernel.gather_mean(x, idx, mask)
        e32 = max_err(got, want, f"gather_mean f32 {label}")
        check_repeat(got, lambda: gm_kernel.gather_mean(x, idx, mask),
                     f"gather_mean f32 {label}")
        xb = x.to(torch.bfloat16)
        want_b = gm_kernel.gather_mean_plain(xb.float(), idx, mask)
        got_b = gm_kernel.gather_mean(xb, idx, mask)
        ebf = max_err(got_b, want_b, f"gather_mean bf16 {label}")
        if not bool((got[:7] == 0).all() and (got_b[:7] == 0).all()):
            raise AssertionError(f"gather_mean {label}: all-masked rows are not 0")
        print(f"   gather_mean {label} N={n} F={f} B={b} k=10: "
              f"f32 max_abs_err={e32:.3g} bf16 max_abs_err={ebf:.3g}")
        errs["gather_mean"] = max(errs["gather_mean"], e32, ebf)
    # Slots of one row above a warp's 32 lanes and 32 // k rows per warp.
    for k in (25, 40):
        x, idx, mask = gather_case(19717, 128, 2560, k, seed=300 + k, dev=dev)
        got = gm_kernel.gather_mean(x, idx, mask)
        e = max_err(got, gm_kernel.gather_mean_plain(x, idx, mask),
                    f"gather_mean f32 k={k}")
        check_repeat(got, lambda: gm_kernel.gather_mean(x, idx, mask),
                     f"gather_mean k={k}")
        print(f"   gather_mean N=19717 F=128 B=2560 k={k}: max_abs_err={e:.3g}")
        errs["gather_mean"] = max(errs["gather_mean"], e)
    csrs = {label: with_isolated_row(g) for label, g in graphs.items()}
    csrs["star"] = star_csr(5000, dev)
    for label, (indptr, edge_dst) in csrs.items():
        n = indptr.numel() - 1
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(dev)
        for normalize in (True, False):
            want = spmm_kernel.spmm_mean_plain(x, indptr, edge_dst, normalize)
            got = spmm_kernel.spmm_mean(x, indptr, edge_dst, normalize)
            check_repeat(got, lambda: spmm_kernel.spmm_mean(x, indptr, edge_dst, normalize),
                         f"spmm_mean {label} normalize={normalize}")
            magnitude = (None if normalize else
                         spmm_kernel.spmm_mean_plain(x.abs(), indptr, edge_dst, False))
            e = max_err(got, want, f"spmm_mean {label} normalize={normalize}",
                        magnitude=magnitude)
            if not bool((got[-1] == 0).all()):
                raise AssertionError(f"spmm_mean {label}: zero-degree row is not 0")
            print(f"   spmm_mean {label} N={n} E={int(indptr[-1])} F=128 "
                  f"normalize={normalize}: max_abs_err={e:.3g}; two launches "
                  f"bitwise equal")
            errs["spmm_mean"] = max(errs["spmm_mean"], e)

    # The training kernels: the scatter at the training shapes (Cora's and
    # Pubmed's layer 0), rows 7..15 sending every slot to one id so that
    # their atomics collide; the dma gather at the four shapes above.
    for i, (label, n, f, b) in enumerate(shapes):
        x, idx, mask = gather_case(n, f, b, 10, seed=200 + i, dev=dev)
        if f == 128:
            idx[7:16], mask[7:16] = 3, True
            g = torch.randn(b, f, generator=torch.Generator().manual_seed(i)).to(dev)
            e32 = max_err(sm_kernel.scatter_mean(g, idx, mask, n),
                          sm_kernel.scatter_mean_plain(g, idx, mask, n),
                          f"scatter_mean f32 {label}")
            # Through the autograd Function with a bf16 table: bf16 gradient.
            xb = x.to(torch.bfloat16).requires_grad_(True)
            gm_kernel.gather_mean(xb, idx, mask).backward(g)
            if xb.grad.dtype != torch.bfloat16:
                raise AssertionError(f"bf16 table got a {xb.grad.dtype} gradient")
            want_b = sm_kernel.scatter_mean_plain(g, idx, mask, n).to(torch.bfloat16)
            ebf = max_err(xb.grad.float(), want_b.float(),
                          f"scatter_mean bf16 grad {label}", BF16_GRAD_TOL)
            print(f"   scatter_mean {label} N={n} F={f} B={b} k=10: "
                  f"f32 max_abs_err={e32:.3g} bf16-table grad max_abs_err={ebf:.3g}")
            errs["scatter_mean"] = max(errs["scatter_mean"], e32)
        got = dma_kernel.gather_mean_dma(x, idx, mask)
        e = max_err(got, dma_kernel.gather_mean_dma_plain(x, idx, mask),
                    f"gather_mean_dma {label}")
        if not bool((got[:7] == 0).all()):
            raise AssertionError(f"gather_mean_dma {label}: all-masked rows are not 0")
        check_repeat(got, lambda: dma_kernel.gather_mean_dma(x, idx, mask),
                     f"gather_mean_dma {label}")
        print(f"   gather_mean_dma {label} N={n} F={f} B={b} k=10: max_abs_err={e:.3g}; "
              f"two launches bitwise equal")
        errs["gather_mean_dma"] = max(errs["gather_mean_dma"], e)

    # Kernels 2 and 4 at the edges of their redesigns. The last id sums 640
    # terms: held to rtol of the terms' summed magnitude.
    for label, x, g, idx, mask in redesign_cases(dev):
        n = x.shape[0]
        want = sm_kernel.scatter_mean_plain(g, idx, mask, n)
        magnitude = sm_kernel.scatter_mean_plain(g.abs(), idx, mask, n)
        es = max_err(sm_kernel.scatter_mean(g, idx, mask, n), want,
                     f"scatter_mean {label}", magnitude=magnitude)
        got = dma_kernel.gather_mean_dma(x, idx, mask)
        e = max_err(got, dma_kernel.gather_mean_dma_plain(x, idx, mask),
                    f"gather_mean_dma {label}")
        check_repeat(got, lambda: dma_kernel.gather_mean_dma(x, idx, mask),
                     f"gather_mean_dma {label}")
        if not bool((got[:7] == 0).all() and (got[9] == 0).all()):
            raise AssertionError(f"gather_mean_dma {label}: all-masked rows are not 0")
        print(f"   {label} (N={n}, g {tuple(g.shape)}, k={idx.shape[1]}): scatter_mean "
              f"max_abs_err={es:.3g}; gather_mean_dma max_abs_err={e:.3g}, bitwise repeat")
        errs["scatter_mean"] = max(errs["scatter_mean"], es)
        errs["gather_mean_dma"] = max(errs["gather_mean_dma"], e)
    before = (sm_kernel.launches, dma_kernel.launches)
    empty = sm_kernel.scatter_mean(g[:0], idx[:0], mask[:0], n)
    if not (empty.shape == (n, g.shape[1]) and bool((empty == 0).all())
            and dma_kernel.gather_mean_dma(x, idx[:0], mask[:0]).shape == (0, x.shape[1])
            and (sm_kernel.launches, dma_kernel.launches) == before):
        raise AssertionError("an empty batch launched a kernel or gave a wrong shape")

    check_sum_modes(shapes, dev, errs)

    # The SpMM backward: symmetric (the kernel again, unnormalised, on
    # g / deg) and directed (a plain transpose), each with a zero-degree row.
    cases = [(label, True, csr) for label, csr in csrs.items()]
    cases += [(label, False, directed_csr(g)) for label, g in graphs.items()]
    for label, symmetric, (indptr, edge_dst) in cases:
        n = indptr.numel() - 1
        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(dev)
        gout = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(dev)
        x_plain = x.clone().requires_grad_(True)
        spmm_kernel.spmm_mean_plain(x_plain, indptr, edge_dst).backward(gout)
        x_kern = x.clone().requires_grad_(True)
        before = spmm_kernel.launches
        spmm_kernel.spmm_mean(x_kern, indptr, edge_dst, symmetric=symmetric).backward(gout)
        want_launches = 2 if symmetric else 1
        if spmm_kernel.launches - before != want_launches:
            raise AssertionError(f"spmm_mean {label} symmetric={symmetric}: "
                                 f"{spmm_kernel.launches - before} launches")
        x_abs = x.clone().requires_grad_(True)
        spmm_kernel.spmm_mean_plain(x_abs, indptr, edge_dst).backward(gout.abs())
        e = max_err(x_kern.grad, x_plain.grad,
                    f"spmm_mean backward {label} symmetric={symmetric}",
                    magnitude=x_abs.grad)
        print(f"   spmm_mean backward {label} N={n} E={int(indptr[-1])} F=128 "
              f"symmetric={symmetric}: max_abs_err={e:.3g}")
        errs["spmm_mean"] = max(errs["spmm_mean"], e)
    return errs


def check_sum_modes(shapes, dev, errs) -> None:
    """The sum modes of kernels 1 and 2 (``normalize=False``, the sharded
    store's owner side) against their plain versions at the training shapes,
    f32 and bf16 tables, rows 7..15 of the scatter colliding on one id, a
    second gather launch bitwise equal to the first."""
    for i, (label, n, f, b) in enumerate(shapes):
        x, idx, mask = gather_case(n, f, b, 10, seed=400 + i, dev=dev)
        errs_here = []
        for table in (x, x.to(torch.bfloat16)):
            got = gm_kernel.gather_mean(table, idx, mask, normalize=False)
            want = gm_kernel.gather_mean_plain(table.float(), idx, mask, False)
            errs_here.append(max_err(got, want, f"gather_mean sum {label} {table.dtype}",
                                     magnitude=gm_kernel.gather_mean_plain(
                                         table.float().abs(), idx, mask, False)))
            check_repeat(got, lambda: gm_kernel.gather_mean(table, idx, mask, normalize=False),
                         f"gather_mean sum {label}")
        errs["gather_mean_sum"] = max(errs["gather_mean_sum"], *errs_here)
        if f != 128:
            continue
        idx[7:16], mask[7:16] = 3, True
        g = torch.randn(b, f, generator=torch.Generator().manual_seed(i)).to(dev)
        es = max_err(sm_kernel.scatter_mean(g, idx, mask, n, normalize=False),
                     sm_kernel.scatter_mean_plain(g, idx, mask, n, normalize=False),
                     f"scatter_mean sum {label}",
                     magnitude=sm_kernel.scatter_mean_plain(g.abs(), idx, mask, n,
                                                            normalize=False))
        errs["scatter_mean_sum"] = max(errs["scatter_mean_sum"], es)
        print(f"   sum modes {label} N={n} F={f} B={b} k=10: gather f32/bf16 "
              f"max_abs_err={errs_here[0]:.3g}/{errs_here[1]:.3g}, scatter "
              f"max_abs_err={es:.3g}")


def directed_csr(graph):
    """A directed CSR from the graph's edges ``u -> v`` with ``u < v`` only,
    plus one zero-degree row appended."""
    e = graph.num_edges
    src = graph.edge_src[:e].cpu().numpy()
    dst = graph.edge_dst[:e].cpu().numpy()
    keep = src < dst
    n = graph.num_nodes + 1
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(src[keep], minlength=n), out=indptr[1:])
    dev = graph.device
    return (torch.from_numpy(indptr).to(dev),
            torch.from_numpy(dst[keep].astype(np.int32)).to(dev))


def slot_stats(idx, mask) -> dict:
    """What a gather-mean over ``idx`` and ``mask`` must touch: its valid
    slots, the rows with one, the valid ids flat with ``F.embedding_bag``'s
    offsets, and the distinct ids among them."""
    flat = idx[mask].long()
    return dict(valid=int(mask.sum()), live=int(mask.any(1).sum()), flat=flat,
                offsets=torch.cat([mask.new_zeros(1, dtype=torch.long),
                                   mask.sum(1).cumsum(0)[:-1]]),
                distinct=torch.unique(flat).numel())


def gather_record(label, what, table, idx, mask, st, normalize=True) -> dict:
    """Kernel 1 on ``table`` over one layer-0 frontier (its sum mode with
    ``normalize=False``): device ms (kernel, plain, ``F.embedding_bag``), the
    bound and ms per call."""
    b, k = idx.shape
    n, f = table.shape
    mode = "mean" if normalize else "sum"
    lib = lambda: F.embedding_bag(st["flat"], table, st["offsets"], mode=mode)  # noqa: E731
    plain = lambda: gm_kernel.gather_mean_plain(table, idx, mask, normalize)  # noqa: E731
    max_err(lib(), plain(), f"embedding_bag yardstick {label} ({mode})")
    bd, by = bound(st["distinct"] * f * 4 + b * k + st["valid"] * 4 + b * f * 4,
                   st["valid"] * f + st["live"] * f)
    kernel = lambda: gm_kernel.gather_mean(table, idx, mask, normalize=normalize)  # noqa: E731
    return dict(
        label=label,
        shape=f"{what}: table [{n},{f}] f32, B={b}, k={k}, {st['valid']} valid "
              f"slots, {st['live']} rows with one, {st['distinct']} distinct rows"
              f"{'' if normalize else ', sum mode'}",
        ms=device_ms(kernel, "gather_mean_kernel"),
        plain_ms=device_ms(plain),
        library_ms=device_ms(lib), bound_ms=bd, bound_by=by, call_ms=call_ms(kernel),
    )


def scatter_record(label, what, table, idx, mask, st, normalize=True) -> dict:
    """Kernel 2, layer 0's backward on the same frontier: a cotangent ``[B,
    F]`` into ``[N, F]``, zeros included (its sum mode with
    ``normalize=False``: unit weights). Library: ``torch.zeros`` and
    ``index_add_`` of the precomputed per-slot rows ``g[b] / cnt[b]`` (the
    sum mode: ``g[b]``) over the valid ids alone (the division is left out
    of its time). The device ms come by kernel name (the zero fill against
    the scatter)."""
    b, k = idx.shape
    n, f = table.shape
    grad = torch.randn(b, f, generator=torch.Generator().manual_seed(4)).to(table.device)
    cnt = mask.sum(1, keepdim=True).clamp(min=1).float() if normalize else 1.0
    rows = (grad / cnt).repeat_interleave(k, dim=0)[mask.reshape(-1)]
    lib = lambda: torch.zeros(n, f, device=table.device).index_add_(0, st["flat"], rows)  # noqa: E731
    max_err(lib(), sm_kernel.scatter_mean_plain(grad, idx, mask, n, normalize),
            f"zeros + index_add_ yardstick {label}")
    bd, by = bound(st["live"] * f * 4 + b * k + st["valid"] * 4 + n * f * 4,
                   st["valid"] * f + st["live"] * f)
    kernel = lambda: sm_kernel.scatter_mean(grad, idx, mask, n, normalize)  # noqa: E731
    split = device_profile(kernel)
    if not any("scatter_mean" in name for name in split):
        raise AssertionError(f"no scatter_mean among the kernels run: {list(split)}")
    split = {name.split("::")[-1].split("(")[0]: ms for name, ms in split.items()}
    print(f"   scatter_mean {label}: device ms by kernel {split}")
    return dict(
        label=label,
        shape=f"{what}: g [{b},{f}] f32 into [{n},{f}], k={k}, {st['valid']} valid "
              f"slots, {st['live']} rows with one{'' if normalize else ', sum mode'}",
        ms=sum(split.values()),
        plain_ms=device_ms(lambda: sm_kernel.scatter_mean_plain(grad, idx, mask, n,
                                                                normalize)),
        library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
        call_ms=call_ms(kernel), split=split,
    )


def print_records(records) -> None:
    for name, recs in records.items():
        for r in recs:
            panels = f", {r['panels']} panel(s)" if "panels" in r else ""
            print(f"   {name} [{r['shape']}]: device ms: kernel {r['ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']}); per call "
                  f"through the wrapper {r['call_ms']:.4f} ms{panels}")


def time_kernels(models, graphs) -> dict:
    """Per kernel, one timing record per graph, on a sampled frontier of the
    preset's batch size.

    Bounds count what the call must move on this frontier: the mask (one
    byte per slot), the ids of valid slots only, the distinct table rows the
    gather reads (the scatter: the gradient rows with a valid slot), and the
    output once."""
    out = {name: [] for name in KERNELS}
    for label, g in graphs.items():
        batch = PRESETS[PRESET_OF[label]].train.batch_size
        table, idx, mask = frontier_inputs(models[label], g, batch, seed=3)
        st = slot_stats(idx, mask)
        out["gather_mean"].append(gather_record(
            label, f"{label} sampled layer 0", table, idx, mask, st))
        # The dma kernel computes the same function on the same inputs.
        kernel = lambda: dma_kernel.gather_mean_dma(table, idx, mask)  # noqa: E731
        out["gather_mean_dma"].append(dict(
            out["gather_mean"][-1],
            ms=device_ms(kernel, "gather_mean_dma_kernel"),
            plain_ms=device_ms(lambda: dma_kernel.gather_mean_dma_plain(table, idx, mask)),
            call_ms=call_ms(kernel),
        ))
        # Layer 0 aggregating first (project_first=False): the same frontier
        # over the raw features (F = 1433 or 500, single-element loads at 1433).
        raw = g.features.contiguous()
        max_err(gm_kernel.gather_mean(raw, idx, mask),
                gm_kernel.gather_mean_plain(raw, idx, mask),
                f"gather_mean mean-first {label}")
        out["gather_mean"].append(gather_record(
            f"{label} mean-first", f"{label} sampled layer 0, mean-first features",
            raw, idx, mask, st))
        kernel = lambda: dma_kernel.gather_mean_dma(raw, idx, mask)  # noqa: E731
        max_err(kernel(), gm_kernel.gather_mean_plain(raw, idx, mask),
                f"gather_mean_dma mean-first {label}")
        out["gather_mean_dma"].append(dict(
            out["gather_mean"][-1],
            ms=device_ms(kernel, "gather_mean_dma_kernel"),
            plain_ms=device_ms(lambda: dma_kernel.gather_mean_dma_plain(raw, idx, mask)),
            call_ms=call_ms(kernel),
        ))
        out["scatter_mean"].append(scatter_record(
            label, f"{label} training layer-0 backward", table, idx, mask, st))
        # The sum modes at the same frontier: a world of one's owner side of
        # the node-sharded exchange serves exactly this batch's requests.
        out["gather_mean_sum"].append(gather_record(
            label, f"{label} sharded owner side", table, idx, mask, st, normalize=False))
        out["scatter_mean_sum"].append(scatter_record(
            label, f"{label} sharded owner side, backward", table, idx, mask, st,
            normalize=False))

        rng = np.random.default_rng(11)
        x = torch.from_numpy(
            rng.standard_normal((g.num_nodes, 128), dtype=np.float32)).to(g.device)
        deg = (g.indptr[1:] - g.indptr[:-1]).long()
        e = g.num_edges
        rows = torch.repeat_interleave(torch.arange(g.num_nodes, device=g.device), deg)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(
                g.indptr.long(), g.edge_dst[:e].long(),
                1.0 / deg.clamp(min=1).float()[rows],
                size=(g.num_nodes, g.num_nodes), check_invariants=True)
        lib = lambda: torch.sparse.mm(a, x)  # noqa: E731
        max_err(lib(), spmm_kernel.spmm_mean_plain(x, g.indptr, g.edge_dst),
                f"sparse.mm yardstick {label}")
        n, f = x.shape
        bd, by = bound(2 * n * f * 4 + (n + 1) * 4 + e * 4, e * f + n * f)
        kernel = lambda: spmm_kernel.spmm_mean(x, g.indptr, g.edge_dst)  # noqa: E731
        out["spmm_mean"].append(dict(
            label=label,
            shape=f"{label} table refresh: X [{n},{f}] f32, E={e}",
            ms=device_ms(kernel, "spmm_mean_kernel"),
            plain_ms=device_ms(
                lambda: spmm_kernel.spmm_mean_plain(x, g.indptr, g.edge_dst)),
            library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
            call_ms=call_ms(kernel), panels=spmm_panels(x),
        ))
        # The layer-0 cache's build: the unnormalised sum over the raw
        # features (F = 1433 or 500). Library: sparse.mm with values 1.
        raw = g.features.contiguous()
        fr = raw.shape[1]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            ones = torch.sparse_csr_tensor(
                g.indptr.long(), g.edge_dst[:e].long(), torch.ones(e, device=g.device),
                size=(g.num_nodes, g.num_nodes), check_invariants=True)
        lib = lambda: torch.sparse.mm(ones, raw)  # noqa: E731
        kernel = lambda: spmm_kernel.spmm_mean(raw, g.indptr, g.edge_dst, False)  # noqa: E731
        max_err(kernel(), spmm_kernel.spmm_mean_plain(raw, g.indptr, g.edge_dst, False),
                f"spmm_mean cache build {label}",
                magnitude=spmm_kernel.spmm_mean_plain(raw.abs(), g.indptr, g.edge_dst,
                                                      False))
        bd, by = bound(2 * n * fr * 4 + (n + 1) * 4 + e * 4, e * fr)
        out["spmm_mean"].append(dict(
            label=f"{label} cache build",
            shape=f"{label} layer-0 cache build: X [{n},{fr}] f32, E={e}, unnormalised",
            ms=device_ms(kernel, "spmm_mean_kernel"),
            plain_ms=device_ms(lambda: spmm_kernel.spmm_mean_plain(
                raw, g.indptr, g.edge_dst, False)),
            library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
            call_ms=call_ms(kernel), panels=spmm_panels(raw),
        ))
    print_records(out)
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serve_tier(model, graph, requests, mode, **kw) -> tuple[list, dict, dict]:
    """Build an engine and answer ``requests`` twice; the launch counts of
    the tier (construction, refresh and requests) come back with the
    answers."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, build_ms = timed(lambda: ServingEngine(model, graph, mode=mode, **kw))
    answers, times = [], []
    for nodes in requests:
        first, ms = timed(lambda: eng.logits(nodes))
        again = eng.logits(nodes)
        if first.shape != (len(nodes), graph.num_classes):
            raise AssertionError(f"{mode}: logits shape {first.shape}")
        if not np.isfinite(first).all():
            raise AssertionError(f"{mode}: non-finite logits")
        if not np.array_equal(first, again):
            raise AssertionError(f"{mode}: a repeated request gave other answers")
        answers.append(first)
        times.append(ms)
    launches = read_launches()
    # Where a request's device time goes (the largest request, warm).
    by_name = device_profile(lambda: eng.logits(requests[-1]), iters=5)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    stats = dict(construct_ms=build_ms, request_ms=times,
                 request_device_ms=sum(by_name.values()),
                 top_kernels=[(short_name(name), ms) for name, ms in top],
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 **eng.memory_stats())
    if mode == "table":  # a warm refresh: host ms (mean of 5) and device ms
        stats["refresh_ms"] = timed(lambda: [eng.refresh() for _ in range(5)])[1] / 5
        stats["refresh_device_ms"] = device_ms(eng.refresh)
    return answers, launches, stats


def tier_kernels(model) -> tuple[str | None, str | None]:
    """The kernel the table tier and the sampled tier of ``model`` launch
    (``None``: none): the full-graph mean runs kernel 3, the full-graph
    maxpool the segment max; the sampled mean layer 0 kernel 1, or kernel 3
    under ``layer0="full"``; the sampled maxpool and lstm are plain PyTorch
    ops."""
    if model.aggregator == "maxpool":
        return "segment_max", None
    if model.aggregator != "mean":
        return None, None
    if model.layer0 == "full":
        return "spmm_mean", "spmm_mean"
    if model.layer0 == "cached":
        return "spmm_mean", None
    return "spmm_mean", "gather_mean"


def serve_preset(name, graph, requests, main_launches, label=None,
                 cover_requests=None) -> None:
    """Serve preset ``name`` on ``graph`` (``label`` in the output) through
    both tiers; the covering-fanout check runs on ``cover_requests``
    (default: ``requests``), which a graph with hub rows keeps small, since
    covering fanouts grow each hop by the largest degree."""
    label = label or name
    model = GraphSAGE.from_config(
        PRESETS[name].model, graph.num_features, graph.num_classes,
        generator=torch.Generator().manual_seed(0),
    )
    table, l_table, s_table = serve_tier(model, graph, requests, "table")
    sampled, l_sampled, s_sampled = serve_tier(model, graph, requests, "sampled")
    print(f"   {label} table tier: launches {l_table}, {s_table}")
    print(f"   {label} sampled tier: launches {l_sampled}, {s_sampled}")
    for tier, launches, kernel in zip(("table", "sampled"), (l_table, l_sampled),
                                      tier_kernels(model)):
        others = any(n for k, n in launches.items() if k != kernel)
        if others or (kernel is not None and launches[kernel] == 0):
            raise AssertionError(f"{label}: the {tier} tier launched {launches}, "
                                 f"want {kernel or 'no kernel'}")
        if kernel is not None:
            main_launches[kernel] += launches[kernel]

    # Covering fanouts see complete neighborhoods: sampled == table.
    max_deg = int(graph.degrees.max())
    kw = {}
    if cover_requests is None:
        cover_requests, cover_table = requests, table
    else:  # no padding to the serving buckets: a bucket of 256 would sample
        # 256 * max_deg**2 slots at the deepest hop
        kw["batch_buckets"] = (max(len(r) for r in cover_requests),)
        cover_table = [ServingEngine(model, graph).logits(r) for r in cover_requests]
    cover, _, _ = serve_tier(model, graph, cover_requests, "sampled",
                             eval_fanouts=(max_deg,) * model.num_layers, **kw)
    for c, t in zip(cover, cover_table):
        np.testing.assert_allclose(c, t, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{label}: covering sampled != table")

    # One sampled frontier through the card's forward and the CPU forward.
    gen = torch.Generator(device=graph.device).manual_seed(5)
    seeds = torch.from_numpy(requests[0].astype(np.int32)).to(graph.device)
    with torch.no_grad():
        fr = model.sample(gen, graph, seeds)
        on_card = model(graph.features, fr, graph=graph).cpu()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu_graph = graph.to("cpu")
        on_cpu = cpu_model(cpu_graph.features, fr.to("cpu"), graph=cpu_graph)
    np.testing.assert_allclose(on_card.numpy(), on_cpu.numpy(), atol=1e-4,
                               err_msg=f"{label}: card forward != CPU forward")
    print(f"   {label}: covering fanout {max_deg} sampled == table; card == CPU "
          f"forward (max diff {float((on_card - on_cpu).abs().max()):.3g})")


def short_name(kernel: str) -> str:
    """A kernel's name without its arguments, at most 48 characters."""
    return kernel.replace("(anonymous namespace)::", "").split("(")[0][-48:]


def step_device_ms(trainer, iters: int = 10) -> tuple[float, list]:
    """Device time of one training step (profiler, summed over kernels) and
    the four kernels that take most of it (a full-batch trainer's step
    takes no seeds)."""
    if isinstance(trainer, FullGraphTrainer):
        step = trainer.step
    else:
        seeds = next(trainer.batches())
        step = lambda: trainer.step(seeds)  # noqa: E731
    by_name = device_profile(step, iters=iters)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), [(short_name(k), v) for k, v in top]


def layer0_slots(model, batch: int) -> int:
    """The neighbour slots the sampled layer 0 gathers for ``batch`` seeds
    (the parent's column counts inside the mean with ``self_loop`` only)."""
    extra = int(model.concat_self or model.self_loop)
    return int(batch * np.prod([f + extra for f in model.fanouts[1:]])
               * (model.fanouts[0] + int(model.self_loop)))


def step_launches(model, num_nodes: int, batch: int) -> dict:
    """Kernel launches of one training step (forward and backward) of
    ``model`` on ``batch`` seeds of a ``num_nodes``-node graph: a sampled
    mean layer 0 launches its gather-mean (kernel 1 on every table type, or
    kernel 4 on the ``dma`` route), and the scatter (kernel 2) only when it
    projects first, since the raw table is frozen."""
    want = {name: 0 for name in KERNELS}
    if model.aggregator != "mean" or model.layer0 == "cached":
        return want
    if model.layer0 == "full":
        want["spmm_mean"] = 2  # forward, and the backward: the kernel on g / deg
    else:
        want["gather_mean_dma" if model.gather_impl == "dma" else "gather_mean"] = 1
        want["scatter_mean"] = int(model.sampled_layer0_project_first(
            num_nodes, layer0_slots(model, batch)))
    return want


def eval_launches(model, train_cfg) -> dict:
    """Kernel launches of the run's one evaluation: the sampled forward with
    ``eval_fanouts``, else the full-graph forward (kernel 3 per mean layer,
    the segment max per maxpool layer)."""
    want = {name: 0 for name in KERNELS}
    if model.aggregator == "maxpool" and train_cfg.eval_fanouts is None:
        want["segment_max"] = model.num_layers
    if model.aggregator != "mean":
        return want
    if train_cfg.eval_fanouts is None:
        want["spmm_mean"] = model.num_layers
    elif model.layer0 != "cached":
        # the forward alone: one launch of the step's kernel
        want.update({k: int(v > 0) for k, v in step_launches(model, 0, 1).items()
                     if k != "scatter_mean"})
    return want


def train_preset(name, root, main_launches, overrides=None, graph=None) -> dict:
    """``run_preset`` (given ``graph``, the preset's ``Trainer`` on it) with
    the launch counters set to 0 just before it and read just after; checks
    the launches per step (a ``layer0="cached"`` run adds the cache's one
    build at construction) and that the losses are finite."""
    cfg = preset_config(name, overrides)
    steps = cfg.train.num_steps
    log: list[str] = []
    reset_launches()
    if graph is None:
        result = run_preset(name, data_root=root, log=log.append, overrides=overrides)
    else:
        trainer = Trainer(build_model(cfg, graph), graph, cfg.train)
        result = trainer.run(log=log.append)
        result["trainer"] = trainer
    launches = read_launches()
    losses = np.asarray(result["losses"])
    model = result["trainer"].model
    per_step = step_launches(model, result["trainer"].graph.num_nodes, cfg.train.batch_size)
    evals = eval_launches(model, cfg.train)
    want = {k: steps * per_step[k] + evals[k] for k in KERNELS}
    if cfg.model.layer0 == "cached" and (graph is None or graph.layer0_cache is None):
        want["spmm_mean"] += 1  # the cache, built at construction
    print(f"   {name} {overrides or ''}: {steps} steps, launches {launches}; "
          f"{log[-2]}; {log[-1]}")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: losses {losses}")
    result["launches"] = launches
    for kernel, count in launches.items():
        main_launches[kernel] += count
    return result


def check_learning(name, result, floor: float | None = None) -> dict:
    """The learning bar: the last loss below 0.7x the first (or below
    ``floor``, a preset's learning floor) and validation micro-F1 above
    0.5; then host and device ms per step and the idle share."""
    losses = result["losses"]
    bar = 0.7 * losses[0] if floor is None else floor
    print(f"   {name}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (bar: below "
          f"{bar:.4f}); val micro-F1 {result['val_micro_f1']:.4f} (bar: above 0.5)")
    if not (losses[-1] < bar and result["val_micro_f1"] > 0.5):
        raise AssertionError(f"{name}: the run did not learn")
    host_ms = result["mean_step_time"] * 1e3
    dev_ms, top = step_device_ms(result["trainer"])
    stats = dict(host_ms_per_step=host_ms, device_ms_per_step=dev_ms,
                 device_idle_share=1.0 - dev_ms / host_ms, top_kernels=top)
    print(f"   {name}: {stats}")
    return stats


def card_vs_cpu_grads(what, model, loss_fn, graph, *args, rtol=GRAD_RTOL,
                      no_grad=()) -> dict:
    """Parameter gradients of ``loss_fn(model, graph, *args)`` on the card
    against a CPU copy of the model on the same inputs, each leaf within
    ``rtol`` of its own largest entry (a leaf with no gradient fails:
    the check would have no power; the leaves named in ``no_grad`` must have
    none, on both); returns the kernel launches of the card's forward and
    backward."""
    model.zero_grad(set_to_none=True)
    reset_launches()
    loss_fn(model, graph, *args).backward()
    launches = read_launches()
    card = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    cpu_model = copy.deepcopy(model).to("cpu")
    loss_fn(cpu_model, graph.to("cpu"), *(a.to("cpu") for a in args)).backward()
    for k, p in cpu_model.named_parameters():
        if k in no_grad:
            if card[k] is not None or p.grad is not None:
                raise AssertionError(f"{what}: {k} has a gradient")
            continue
        if not (torch.isfinite(card[k]).all() and torch.isfinite(p.grad).all()):
            raise AssertionError(f"{what}: grad {k} is not finite")
        card[k] = card[k].cpu()
        scale = float(p.grad.abs().max())
        diff = float((card[k] - p.grad).abs().max())
        print(f"   {what}: grad {k} {tuple(p.shape)}: max |grad| {scale:.4g}, "
              f"max |card - CPU| {diff:.3g} ({diff / scale if scale else float('nan'):.3g}"
              f" of the largest entry)")
        if not (scale > 0 and diff <= rtol * scale):
            raise AssertionError(f"{what}: grad {k}: card differs from the CPU by "
                                 f"{diff:.3g}, its largest entry is {scale:.3g}")
    print(f"   {what}: card == CPU gradients; launches {launches}")
    return launches


def sampled_loss(model, graph, frontier, seeds):
    return model.loss(graph.features, frontier, graph.labels[seeds.long()], graph=graph)


def full_graph_loss(model, graph, nodes):
    logits = model.forward_full_graph(graph)[nodes]
    return model.classification_loss(logits, graph.labels[nodes]).mean()


def check_gradients(trainers) -> None:
    """Card against CPU gradients of freshly initialised models (the trained
    ones have gradients near 0) on each trainer's graph and first batch."""
    fresh = {label: build_model(preset_config(PRESET_OF[label]), tr.graph)
             for label, tr in trainers.items()}
    for label, tr in trainers.items():
        seeds = torch.from_numpy(next(tr.batches())).to(tr.device)
        gen = torch.Generator(device=tr.device).manual_seed(11)
        frontier = fresh[label].sample(gen, tr.graph, seeds)
        launches = card_vs_cpu_grads(f"{label} sampled step", fresh[label],
                                     sampled_loss, tr.graph, frontier, seeds)
        want = step_launches(fresh[label], tr.graph.num_nodes, len(seeds))
        if launches != want:
            raise AssertionError(f"{label}: one step's forward and backward "
                                 f"launched {launches}, want {want}")
    if "cora" not in trainers:
        return
    tr, model = trainers["cora"], fresh["cora"]
    nodes = torch.from_numpy(tr.train_nodes).to(tr.device).long()
    with torch.no_grad():
        reset_launches()
        model.forward_full_graph(tr.graph)
        forward_only = read_launches()["spmm_mean"]
    launches = card_vs_cpu_grads("cora full-graph loss over the train split",
                                 model, full_graph_loss, tr.graph, nodes)
    backward = launches["spmm_mean"] - forward_only
    print(f"   cora full-graph loss: spmm_mean launched {forward_only} times in "
          f"the forward and {backward} in the backward")
    if backward <= 0:
        raise AssertionError("the full-graph backward did not launch spmm_mean")


def project_first_times(trainers, iters: int = 10, batch_scales=(1,)) -> dict:
    """Host and device ms of one training step of each preset with layer 0
    projecting first and aggregating first, on the same graph; at each of
    ``batch_scales`` times the preset's batch, so that the layer-0 slots per
    table row (what the order rule weighs) run across the crossover."""
    out = {}
    for name, tr in trainers.items():
        for scale in batch_scales:
            for pf in (True, False):
                base = PRESETS[PRESET_OF[name]].train.batch_size
                over = {**OVERRIDES_OF.get(name, {}), "batch_size": base * scale}
                cfg = preset_config(PRESET_OF[name], {**over, "project_first": pf})
                model = build_model(cfg, tr.graph)
                t = Trainer(model, tr.graph, cfg.train)
                seeds = next(t.batches())
                for _ in range(3):
                    t.step(seeds)
                _, ms = timed(lambda: [t.step(seeds) for _ in range(iters)])
                dev_ms, _ = step_device_ms(t)
                slots = layer0_slots(model, cfg.train.batch_size)
                auto = build_model(preset_config(PRESET_OF[name], over), tr.graph)
                out[f"{name} batch {cfg.train.batch_size} project_first={pf}"] = dict(
                    host_ms=ms / iters, device_ms=dev_ms, slots=slots,
                    slots_per_row=slots / tr.graph.num_nodes,
                    rule=auto.sampled_layer0_project_first(tr.graph.num_nodes, slots))
                del t, model, auto
                torch.cuda.empty_cache()
    for k, v in out.items():
        print(f"   {k}: {v['slots']} layer-0 slots, {v['slots_per_row']:.3f} per table "
              f"row (\"auto\" projects first: {v['rule']}): host ms per step "
              f"{v['host_ms']:.3f}, device ms per step {v['device_ms']:.4f}")
    return out


def graph_with_isolated_row(graph):
    """``graph`` with one zero-degree node appended (a random feature row),
    enough for the cache's build: features, CSR and degrees."""
    row = torch.randn(1, graph.num_features, generator=torch.Generator().manual_seed(6))
    indptr, _ = with_isolated_row(graph)
    return dataclasses.replace(
        graph, num_nodes=graph.num_nodes + 1, indptr=indptr,
        features=torch.cat([graph.features, row.to(graph.device)]),
        degrees=torch.cat([graph.degrees, graph.degrees.new_zeros(1)]),
    )


def check_cache(graphs) -> float:
    """The card's layer-0 cache (kernel 3, one launch per build) against the
    plain build on the CPU, on each graph with a zero-degree row, both
    flavors; each entry within ``rtol`` of the mean of its terms'
    magnitudes. Returns the largest difference."""
    worst = 0.0
    for label, g in graphs.items():
        g = graph_with_isolated_row(g)
        cpu = g.to("cpu")
        for self_loop in (False, True):
            reset_launches()
            got = with_cached_layer0(g, self_loop=self_loop).layer0_cache
            launches = read_launches()
            if launches != {**{k: 0 for k in KERNELS}, "spmm_mean": 1}:
                raise AssertionError(f"cache {label}: launches {launches}")
            want = with_cached_layer0(cpu, self_loop=self_loop).layer0_cache
            magnitude = with_cached_layer0(
                dataclasses.replace(cpu, features=cpu.features.abs()),
                self_loop=self_loop).layer0_cache
            e = max_err(got.cpu(), want, f"cache {label} self_loop={self_loop}",
                        magnitude=magnitude)
            last = g.features[-1] if self_loop else torch.zeros_like(g.features[-1])
            if not torch.equal(got[-1], last):
                raise AssertionError(f"cache {label}: the zero-degree row is wrong")
            print(f"   cache {label} N={g.num_nodes} F={g.num_features} "
                  f"self_loop={self_loop}: max_abs_err={e:.3g}")
            worst = max(worst, e)
    return worst


def cache_build_ms(graph) -> dict:
    """Host ms (mean of 5) and device ms of building the cache."""
    host = timed(lambda: [with_cached_layer0(graph) for _ in range(5)])[1] / 5
    return dict(host_ms=host, device_ms=device_ms(lambda: with_cached_layer0(graph),
                                                  "spmm_mean_kernel"))


def layer0_mode_times(graph, overrides=None, iters: int = 10) -> dict:
    """Host and device ms of one training step of the Pubmed preset in each
    layer-0 mode on ``graph`` (the cache built before the timing)."""
    out = {}
    for mode, name in LAYER0_PRESETS.items():
        cfg = preset_config(name, overrides)
        t = Trainer(build_model(cfg, graph), graph, cfg.train)
        seeds = next(t.batches())
        for _ in range(3):
            t.step(seeds)
        _, ms = timed(lambda: [t.step(seeds) for _ in range(iters)])
        dev_ms, top = step_device_ms(t)
        out[mode] = dict(host_ms=ms / iters, device_ms=dev_ms,
                         idle_share=1.0 - dev_ms / (ms / iters), top_kernels=top)
    return out


def gather_backward_times(graphs) -> None:
    """Device ms of ``pubmed_layer0_full``'s table gather at hop 1 (a
    1024-seed frontier into a [N, 128] table, forward and backward) by
    indexing, ``table[ids]``, whose backward sorts the ids and adds each run
    of equal ids in turn, and by ``gather`` (``index_select``, backward
    ``index_add_``). On the synthetic Pubmed graph every masked slot of
    hop 1 names node 0."""
    for label in ("pubmed", "pubmed heavy-tailed"):
        g = graphs[label]
        model = build_model(preset_config("pubmed_layer0_full"), g)
        gen = torch.Generator(device=g.device).manual_seed(9)
        seeds = torch.randint(0, g.num_nodes, (1024,), generator=gen,
                              device=g.device, dtype=torch.int32)
        fr = model.sample(gen, g, seeds)
        ids = fr.ids[1]
        table = torch.randn(g.num_nodes, 128, device=g.device, requires_grad=True)
        gout = torch.randn(ids.numel(), 128, device=g.device)
        indexing = device_ms(lambda: table[ids.long()].backward(gout))
        selected = device_ms(lambda: gather(table, ids).backward(gout))
        print(f"   {label}: hop 1 {ids.numel()} slots, {int((~fr.masks[1]).sum())} "
              f"masked, node 0 named {int((ids == 0).sum())} times; device ms of "
              f"the gather forward and backward: table[ids] {indexing:.4f}, "
              f"gather (index_select) {selected:.4f}")


# ---------------------------------------------------------- reduced precision
# The learning floors of the reduced-precision presets (bench.py's, the
# final loss each run must end below).
FLOORS = {"reddit": 0.5, "powerlaw": 0.5, "powerlaw_1m": 0.8,
          "powerlaw_1m_layer0_cached": 0.8, "powerlaw_1m int8 table": 0.8}
# A bf16 result is an f32 sum rounded once: sums in another order may round
# to the neighbouring bf16 value, one step of 2**-7 relative.
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)
# Card against CPU gradients and forwards of bf16 models: bf16 products
# round on both devices, in other orders; each leaf within this fraction of
# its largest entry.
BF16_GRAD_RTOL = 2e-2


def deepest_hop(model, graph, batch, seed):
    """The sampled frontier's deepest hop, ``(idx [n_out, k], mask)``: what
    the sampled mean layer 0 gathers for one ``batch``-seed step."""
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    seeds = torch.randint(0, graph.num_nodes, (batch,), generator=gen,
                          device=graph.device, dtype=torch.int32)
    fr = model.sample(gen, graph, seeds)
    L = model.num_layers
    n_out = fr.ids[L - 1].numel()
    return (fr.ids[L].reshape(n_out, -1).contiguous(),
            fr.masks[L].reshape(n_out, -1).contiguous())


def int8_edge_rows(qt, idx, mask):
    """An int8 table with row 5 at scale 0 and the frontier's first row all
    masked, second row naming only row 5 (the kernel checks' edge cases)."""
    scale = qt.scale.clone()
    scale[5] = 0.0
    idx, mask = idx.clone(), mask.clone()
    mask[0] = False
    idx[1], mask[1] = 5, True
    return tq.QuantizedTable(qt.q, scale), idx, mask


def check_precision_kernels(pg) -> dict:
    """The new routes against their plain versions and a second launch of
    themselves (each sums in a fixed order: bitwise equal): kernel 3 on bf16
    rows at F=128, 256 and 602, normalised and not, and its backward;
    kernel 4 on bf16 at F=128 and 602; kernel 1 on int8 at F=256 and 602
    (a zero-scale row, an all-masked row) and on bf16 at F=602."""
    errs = {name: 0.0 for name in KERNELS}
    reddit = pg["reddit"]
    rng = np.random.default_rng(21)
    # Kernel 3 on the Reddit stand-in's CSR at the refresh width, the
    # powerlaw one's at 256, and F=602 on a 30000-node graph of Reddit's
    # width (the plain version's per-edge f32 rows of the full Reddit graph
    # at 602 would take 28 GB).
    for label, g, f in (("reddit", reddit, 128), ("powerlaw", pg["powerlaw"], 256),
                        ("30000-node F=602", pg["check"], 602),
                        ("30000-node F=601 (odd: unaligned pairs)", pg["check"], 601)):
        x = torch.from_numpy(rng.standard_normal((g.num_nodes, f), dtype=np.float32)
                             ).to(g.device).to(torch.bfloat16)
        for normalize in (True, False):
            got = spmm_kernel.spmm_mean(x, g.indptr, g.edge_dst, normalize)
            check_repeat(got, lambda: spmm_kernel.spmm_mean(x, g.indptr, g.edge_dst,
                                                            normalize),
                         f"spmm_mean bf16 {label} normalize={normalize}")
            want = spmm_kernel.spmm_mean_plain(x, g.indptr, g.edge_dst, normalize)
            magnitude = None if normalize else spmm_kernel.spmm_mean_plain(
                x.abs(), g.indptr, g.edge_dst, False).float()
            if got.dtype != torch.bfloat16:
                raise AssertionError(f"spmm_mean bf16 {label}: output {got.dtype}")
            e = max_err(got.float(), want.float(), f"spmm_mean bf16 {label} F={f} "
                        f"normalize={normalize}", BF16_TOL, magnitude=magnitude)
            print(f"   spmm_mean bf16 {label} N={g.num_nodes} E={g.num_edges} F={f} "
                  f"normalize={normalize}: max_abs_err={e:.3g}; bitwise repeat")
            errs["spmm_mean"] = max(errs["spmm_mean"], e)
            del want, magnitude
        if f != 256:
            gout = torch.randn(g.num_nodes, f, device=g.device).to(torch.bfloat16)
            xk = x.clone().requires_grad_(True)
            spmm_kernel.spmm_mean(xk, g.indptr, g.edge_dst).backward(gout)
            xp = x.clone().requires_grad_(True)
            spmm_kernel._SpmmMean.apply(xp, g.indptr, g.edge_dst, True, True,
                                        spmm_kernel.spmm_mean_plain).backward(gout)
            if xk.grad.dtype != torch.bfloat16:
                raise AssertionError(f"spmm_mean bf16 backward: {xk.grad.dtype}")
            xa = x.clone().abs().requires_grad_(True)
            spmm_kernel._SpmmMean.apply(xa, g.indptr, g.edge_dst, True, True,
                                        spmm_kernel.spmm_mean_plain).backward(gout.abs())
            e = max_err(xk.grad.float(), xp.grad.float(),
                        f"spmm_mean bf16 backward {label} F={f}", BF16_TOL,
                        magnitude=xa.grad.float())
            print(f"   spmm_mean bf16 backward {label} F={f}: max_abs_err={e:.3g}")
            errs["spmm_mean"] = max(errs["spmm_mean"], e)
            del xk, xp, xa, gout

    model = pg["models"]["reddit"]
    idx, mask = deepest_hop(model, reddit, PRESETS["reddit"].train.batch_size, 22)
    mask[:7] = False
    with torch.no_grad():
        table = (reddit.features @ model.layers[0].weight.to(torch.bfloat16)).contiguous()
    for label, x in (("reddit projected F=128", table), ("reddit raw F=602", reddit.features)):
        want = gm_kernel.gather_mean_plain(x, idx, mask)
        for name, mod, fn in (("gather_mean_dma", dma_kernel, dma_kernel.gather_mean_dma),
                              ("gather_mean", gm_kernel, gm_kernel.gather_mean)):
            got = fn(x, idx, mask)
            e = max_err(got, want, f"{name} bf16 {label}")
            check_repeat(got, lambda: fn(x, idx, mask), f"{name} bf16 {label}")
            if not bool((got[:7] == 0).all()):
                raise AssertionError(f"{name} bf16 {label}: all-masked rows are not 0")
            print(f"   {name} bf16 {label} B={idx.shape[0]} k={idx.shape[1]}: "
                  f"max_abs_err={e:.3g}; bitwise repeat")
            errs[name] = max(errs[name], e)

    for label, g, model in (("powerlaw_1m F=256", pg["powerlaw_1m"], pg["models"]["powerlaw_1m"]),
                            ("reddit F=602", reddit, pg["models"]["reddit"])):
        qt = tq.quantize_features(g.features)
        b = PRESETS["powerlaw_1m" if "1m" in label else "reddit"].train.batch_size
        torch.cuda.empty_cache()
        qt, i8, m8 = int8_edge_rows(qt, *deepest_hop(model, g, b, 23))
        got = gm_kernel.gather_mean_int8(qt.q, qt.scale, i8, m8)
        want = gm_kernel.gather_mean_int8_plain(qt.q, qt.scale, i8, m8)
        e = max_err(got, want, f"gather_mean int8 {label}")
        check_repeat(got, lambda: gm_kernel.gather_mean_int8(qt.q, qt.scale, i8, m8),
                     f"gather_mean int8 {label}")
        if not bool((got[:2] == 0).all()):
            raise AssertionError(f"gather_mean int8 {label}: masked or zero-scale rows")
        print(f"   gather_mean int8 {label} B={i8.shape[0]} k={i8.shape[1]}: "
              f"max_abs_err={e:.3g}; bitwise repeat; the all-masked and the "
              f"zero-scale rows are 0")
        errs["gather_mean"] = max(errs["gather_mean"], e)
    return errs


def library_ms(bf16_call, cast_call, what: str) -> tuple[float, str]:
    """Device ms of the library call on the route's own dtype, or, where the
    library does not take it on the card, on the cast table (said so)."""
    try:
        bf16_call()
        torch.cuda.synchronize()
        return device_ms(bf16_call), "on the route's dtype"
    except (RuntimeError, NotImplementedError) as exc:
        print(f"   {what}: the library call refused the dtype "
              f"({str(exc).splitlines()[0][:80]}); timed on the f32 table")
        return device_ms(cast_call), "on the f32 cast table"


def time_precision_kernels(pg) -> dict:
    """The new routes at the slice's shapes (the presets' sampled layer-0
    frontiers, the 1M-node cache build, the Reddit table refresh): device
    ms (profiler), plain, library, bound and per-call ms. Bounds as in
    ``time_kernels``, in the route's bytes; kernel 3's cache build also
    with one row read per edge (the table does not fit the 50 MB L2)."""
    out = {name: [] for name in KERNELS}

    def gather_record(label, x_bytes_per_row, f, idx, mask, kernel, plain, lib, note,
                      extra_ops=0):
        b, k = idx.shape
        valid = int(mask.sum())
        live = int(mask.any(1).sum())
        distinct = torch.unique(idx[mask]).numel()
        bd, by = bound(distinct * x_bytes_per_row + b * k + valid * 4 + b * f * 4,
                       valid * f + live * f + extra_ops * valid * f)
        return dict(label=label, shape=f"{label}: B={b}, k={k}, {valid} valid slots, "
                    f"{distinct} distinct rows", ms=device_ms(kernel, "gather_mean"),
                    plain_ms=device_ms(plain), library_ms=lib[0], library_note=note or lib[1],
                    bound_ms=bd, bound_by=by, call_ms=call_ms(kernel))

    reddit = pg["reddit"]
    rm = pg["models"]["reddit"]
    idx, mask = deepest_hop(rm, reddit, PRESETS["reddit"].train.batch_size, 31)
    flat = idx[mask].long()
    offsets = torch.cat([mask.new_zeros(1, dtype=torch.long), mask.sum(1).cumsum(0)[:-1]])
    with torch.no_grad():
        table = (reddit.features @ rm.layers[0].weight.to(torch.bfloat16)).contiguous()
    n = reddit.num_nodes
    for label, x in ((f"reddit project-first: table [{n},128] bf16", table),
                     (f"reddit mean-first: features [{n},602] bf16", reddit.features)):
        f = x.shape[1]
        lib = library_ms(lambda: F.embedding_bag(flat, x, offsets, mode="mean"),
                         lambda: F.embedding_bag(flat, x.float(), offsets, mode="mean"),
                         f"embedding_bag {label}")
        for name, mod, fn, plain in (
                ("gather_mean", gm_kernel, gm_kernel.gather_mean, gm_kernel.gather_mean_plain),
                ("gather_mean_dma", dma_kernel, dma_kernel.gather_mean_dma,
                 dma_kernel.gather_mean_dma_plain)):
            out[name].append(gather_record(
                label, 2 * f, f, idx, mask, lambda: fn(x, idx, mask),
                lambda: plain(x, idx, mask), lib, None))

    g1m, m1m = pg["powerlaw_1m"], pg["models"]["powerlaw_1m"]
    idx, mask = deepest_hop(m1m, g1m, PRESETS["powerlaw_1m"].train.batch_size, 32)
    flat = idx[mask].long()
    offsets = torch.cat([mask.new_zeros(1, dtype=torch.long), mask.sum(1).cumsum(0)[:-1]])
    x = g1m.features
    lib = library_ms(lambda: F.embedding_bag(flat, x, offsets, mode="mean"),
                     lambda: F.embedding_bag(flat, x.float(), offsets, mode="mean"),
                     "embedding_bag powerlaw_1m")
    n = g1m.num_nodes
    out["gather_mean"].append(gather_record(
        f"powerlaw_1m mean-first: features [{n},256] bf16", 512, 256, idx, mask,
        lambda: gm_kernel.gather_mean(x, idx, mask),
        lambda: gm_kernel.gather_mean_plain(x, idx, mask), lib, None))
    qt = pg["powerlaw_1m int8"].features
    dense = tq.dequantize(qt)
    lib = (device_ms(lambda: F.embedding_bag(flat, dense, offsets, mode="mean")),
           "on the dequantized f32 table (embedding_bag takes no int8 table)")
    out["gather_mean"].append(gather_record(
        f"powerlaw_1m int8 table: q [{n},256] int8 + scales", 256 + 4, 256, idx, mask,
        lambda: gm_kernel.gather_mean_int8(qt.q, qt.scale, idx, mask),
        lambda: gm_kernel.gather_mean_int8_plain(qt.q, qt.scale, idx, mask), lib, None,
        extra_ops=1))
    del dense

    # Kernel 3 on bf16 rows: the 1M-node cache build (normalised, the
    # cache's non-self-loop flavor), the Reddit table refresh's layer 1, and
    # an even and an odd width on one graph (pairs, and pairs read from any
    # 2-byte address).
    torch.cuda.empty_cache()
    gc = pg["check"]
    wide = torch.randn(gc.num_nodes, 602, device=gc.device).to(torch.bfloat16)
    for label, g, x in (
            (f"powerlaw_1m cache build: X [{n},256] bf16", g1m, g1m.features),
            (f"reddit table refresh: X [{reddit.num_nodes},128] bf16", reddit, table),
            (f"30000-node graph: X [{gc.num_nodes},602] bf16", gc, wide),
            (f"30000-node graph: X [{gc.num_nodes},601] bf16 (odd)", gc,
             wide[:, :601].contiguous())):
        n, f = x.shape
        e = g.num_edges
        deg = (g.indptr[1:] - g.indptr[:-1]).long()
        rows = torch.repeat_interleave(torch.arange(n, device=g.device), deg)
        vals = (1.0 / deg.clamp(min=1).float())[rows]
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a32 = torch.sparse_csr_tensor(g.indptr.long(), g.edge_dst[:e].long(), vals,
                                          size=(n, n))
            a16 = torch.sparse_csr_tensor(g.indptr.long(), g.edge_dst[:e].long(),
                                          vals.to(torch.bfloat16), size=(n, n))
            lib = library_ms(lambda: torch.sparse.mm(a16, x),
                             lambda: torch.sparse.mm(a32, x.float()),
                             f"sparse.mm {label}")
        kernel = lambda: spmm_kernel.spmm_mean(x, g.indptr, g.edge_dst)  # noqa: E731
        fixed = 2 * n * f * 2 + (n + 1) * 4 + e * 4
        bd, by = bound(fixed, e * f + n * f)
        per_edge, _ = bound(e * f * 2 + n * f * 2 + (n + 1) * 4 + e * 4, 0)
        out["spmm_mean"].append(dict(
            label=label, shape=f"{label}, E={e}", ms=device_ms(kernel, "spmm_mean_kernel"),
            plain_ms=device_ms(lambda: spmm_kernel.spmm_mean_plain(x, g.indptr, g.edge_dst)),
            library_ms=lib[0], library_note=lib[1], bound_ms=bd, bound_by=by,
            bound_row_per_edge_ms=per_edge, call_ms=call_ms(kernel), panels=spmm_panels(x)))
        del a32, a16, rows, vals
        torch.cuda.empty_cache()
    for name, recs in out.items():
        for r in recs:
            extra = (f", one row per edge {r['bound_row_per_edge_ms']:.4f}"
                     if "bound_row_per_edge_ms" in r else "")
            panels = f", {r['panels']} panel(s)" if "panels" in r else ""
            print(f"   {name} [{r['shape']}]: device ms: kernel {r['ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
                  f"({r['library_note']}), bound {r['bound_ms']:.4f} ({r['bound_by']})"
                  f"{extra}; per call through the wrapper {r['call_ms']:.4f} ms{panels}")
    return out


def check_bf16_instances(trainer, want: str) -> None:
    """The kernels of one training step include a template instance for the
    table's row type (``want``, e.g. ``gather_mean_kernel<__nv_bfloat16``)."""
    seeds = next(trainer.batches())
    names = device_profile(lambda: trainer.step(seeds), iters=2)
    if not any(want in name for name in names):
        raise AssertionError(f"no {want} among {[short_name(n) for n in names]}")
    print(f"   the step ran {short_name(next(n for n in names if want in n))}")


def precision_gradients() -> None:
    """Card against CPU gradients of fresh bf16 models (the ``reddit`` and
    ``powerlaw`` presets, and ``powerlaw`` over an int8 table) on small
    power-law graphs of the presets' widths, within ``BF16_GRAD_RTOL``."""
    cases = (("reddit", dict(num_feats=602, num_classes=41), False),
             ("powerlaw", dict(num_feats=256, num_classes=16), False),
             ("powerlaw", dict(num_feats=256, num_classes=16), True))
    for name, shape, int8 in cases:
        g = power_law_graph(20000, 120000, homophily=0.8, feature_dtype=torch.bfloat16,
                            **shape)
        if int8:
            g = quantize_graph(g)
        cfg = preset_config(name)
        model = build_model(cfg, g)
        # 256 seeds: the CPU side runs the same bf16 products without a card.
        seeds = torch.arange(0, 512, 2, device=g.device, dtype=torch.int32)
        frontier = model.sample(torch.Generator(device=g.device).manual_seed(13), g, seeds)
        label = f"{name} bf16{' int8 table' if int8 else ''} (N=20000)"
        launches = card_vs_cpu_grads(label, model, sampled_loss, g, frontier, seeds,
                                     rtol=BF16_GRAD_RTOL)
        want = step_launches(model, g.num_nodes, len(seeds))
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, want {want}")


def serve_precision(pg, main_launches) -> None:
    """``reddit`` through both tiers (launch counts as ``tier_kernels``
    says). Its covering-fanout check is left out: the stand-in's hubs hold
    thousands of edges, and covering fanouts grow each hop by that many;
    ``precision_gradients`` holds a Reddit-width model's card forward and
    gradients against the CPU's. Then a bf16 ``powerlaw`` model
    through the table tier with and without ``quantize_table``: peak memory,
    the table's bytes, and every representation within half a quantization
    step."""
    g = pg["reddit"]
    rng = np.random.default_rng(40)
    requests = [rng.integers(0, g.num_nodes, size) for size in (256, 1000)]
    model = build_model(preset_config("reddit"), g)
    for mode, kernel in zip(("table", "sampled"), tier_kernels(model)):
        answers, launches, stats = serve_tier(model, g, requests, mode)
        others = any(n for k, n in launches.items() if k != kernel)
        if others or launches[kernel] == 0:
            raise AssertionError(f"reddit {mode} tier launched {launches}")
        main_launches[kernel] += launches[kernel]
        print(f"   reddit {mode} tier: launches {launches}, {stats}")

    g = pg["powerlaw"]
    model = build_model(preset_config("powerlaw"), g)
    requests = [rng.integers(0, g.num_nodes, 1024)]
    dense, l_dense, s_dense = serve_tier(model, g, requests, "table")
    quant, l_quant, s_quant = serve_tier(model, g, requests, "table", quantize_table=True)
    for tier, launches in (("table", l_dense), ("int8 table", l_quant)):
        if launches != {**{k: 0 for k in KERNELS}, "spmm_mean": launches["spmm_mean"]} \
                or launches["spmm_mean"] == 0:
            raise AssertionError(f"powerlaw {tier} tier launched {launches}")
        main_launches["spmm_mean"] += launches["spmm_mean"]
    with torch.no_grad():
        emb = ServingEngine(model, g).embed(requests[0])
        emb_q = ServingEngine(model, g, quantize_table=True).embed(requests[0])
    step = np.abs(emb).max(axis=1, keepdims=True) / 127.0
    if not (np.abs(emb_q - emb) <= step / 2 + 1e-6).all():
        raise AssertionError("powerlaw int8 table: a representation moved more "
                             "than half a quantization step")
    agree = float((dense[0].argmax(1) == quant[0].argmax(1)).mean())
    for tier, stats in (("table", s_dense), ("int8 table", s_quant)):
        print(f"   powerlaw bf16 {tier} tier: table bytes {stats['table_bytes_per_chip']}, "
              f"peak memory {stats['max_memory_allocated']}, request ms "
              f"{stats['request_ms']}, device ms {stats['request_device_ms']:.4f}, "
              f"refresh device / host ms {stats['refresh_device_ms']:.4f} / "
              f"{stats['refresh_ms']:.3f}")
    print(f"   powerlaw int8 table: predictions agree with the bf16 table's on "
          f"{agree:.4f} of 1024 nodes; representations within half a step")


# ------------------------------------------- samplers, full-batch, multilabel
# bench.py's full-batch configuration (its fullbatch row and floor).
FULLBATCH_GRAPH = dict(num_nodes=100_000, num_edges=1_000_000, num_feats=128,
                       num_classes=16, seed=0, homophily=0.8)
FULLBATCH_FLOOR = 0.8
# The GraphSAGE paper's PPI shape: 24 graphs of about 2372 nodes, 50
# features, 121 labels, about 28 edge slots per node; 20 graphs train, 4 are
# held out. The model and bars of tests/test_multilabel.py.
PPI = dict(num_graphs=24, num_nodes=2372, num_feats=50, num_classes=121,
           edges_per_node=14, seed=0)
PPI_TRAIN_GRAPHS = 20
PPI_STEPS = 100
PPI_MODEL = dict(hidden_dims=(64, 64), fanouts=(10, 10), multilabel=True, concat_self=True)
PPI_TRAIN = dict(batch_size=256, num_steps=PPI_STEPS, log_every=0, learning_rate=0.01,
                 optimizer="adam", test_size=0, val_size=200)


def full_graph_step_launches(model) -> dict:
    """Kernel 3's launches in one full-batch step of a mean model: one per
    layer in the forward, and one per layer whose SpMM input needs a
    gradient in the backward (layer 0's only when it projects first: the
    features are frozen); none for maxpool and lstm."""
    want = {name: 0 for name in KERNELS}
    if model.aggregator == "mean":
        backward = sum(1 for l in range(model.num_layers)
                       if l > 0 or model.use_project_first(0, model.in_dim))
        want["spmm_mean"] = model.num_layers + backward
    return want


def train_full_graph(label, main_launches, model=None, graph=None, cfg=None,
                     preset=None, root=None) -> dict:
    """A ``FullGraphTrainer`` run (``run_preset(preset, mode="full-graph")``
    when ``preset`` is given) with the launch counters set to 0 just before
    it and read just after: kernel 3 launches ``full_graph_step_launches``
    per step and once per layer in the evaluation."""
    log: list[str] = []
    reset_launches()
    if preset is not None:
        result = run_preset(preset, data_root=root, log=log.append, mode="full-graph")
        trainer = result["trainer"]
    else:
        trainer = FullGraphTrainer(model, graph, cfg)
        result = trainer.run(log=log.append)
        result["trainer"] = trainer
    launches = read_launches()
    model, steps = trainer.model, trainer.cfg.num_steps
    per_step = full_graph_step_launches(model)
    want = {k: steps * v for k, v in per_step.items()}
    if model.aggregator == "mean":
        want["spmm_mean"] += model.num_layers  # the evaluation's forward
    losses = np.asarray(result["losses"])
    print(f"   {label}: {steps} full-batch steps, launches {launches} "
          f"({per_step['spmm_mean']} of kernel 3 per step; the backward on "
          f"{'g / deg (symmetric graph)' if trainer.graph.symmetric else 'the index_add_ transpose (directed graph)'}); "
          f"{log[-2]}; {log[-1]}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    if per_step["spmm_mean"]:  # the profiler sees kernel 3 in a step
        device_ms(trainer.step, "spmm_mean_kernel", iters=2)
    result["launches"] = launches
    for kernel, count in launches.items():
        main_launches[kernel] += count
    return result


def sampling_stage_ms(pg, pubmed) -> None:
    """Device ms of the sampling stage by method: one hop at fanout 15 (the
    ``powerlaw_1m`` preset's first expansion) over a 4096-seed batch, and the
    preset's whole three-hop frontier, on the 10^6-node graph (floyd and
    windowed: its ELL is capped, which ``topk`` refuses) and on the
    synthetic Pubmed graph, whose ELL covers every row (all three)."""
    for label, g in (("powerlaw_1m", pg["powerlaw_1m"]), ("synthetic pubmed", pubmed)):
        gen = torch.Generator(device=g.device).manual_seed(41)
        seeds = torch.randint(0, g.num_nodes, (4096,), generator=gen, device=g.device,
                              dtype=torch.int32)
        methods = ("floyd", "windowed") + (("topk",) if g.ell_covers_all else ())
        for method in methods:
            def hop():
                return sample_neighbors(gen, g.neighbors, g.degrees, seeds, 15, method=method,
                                        indptr=g.indptr, edge_dst=g.edge_dst,
                                        ell_covers_all=g.ell_covers_all)
            # Sampling reads no parameter: narrow layers of the preset's depth.
            model = GraphSAGE(g.num_features, g.num_classes, (8, 8, 8),
                              PRESETS["powerlaw_1m"].model.fanouts, sampling=method)
            frontier = lambda: model.sample(gen, g, seeds)  # noqa: E731
            # Hundreds of small kernels a call: few iterations under the profiler.
            print(f"   sampling {label} {method}: one hop of fanout 15 over 4096 seeds "
                  f"device ms {device_ms(hop, iters=5):.4f} (per call "
                  f"{call_ms(hop, iters=10):.4f}); the 3-hop frontier (5/10/15) device ms "
                  f"{device_ms(frontier, iters=5):.4f} (per call "
                  f"{call_ms(frontier, iters=5):.4f})")
            del model


def windowed_runs(pg, results, main_launches) -> None:
    """``powerlaw_1m`` and ``powerlaw_1m_layer0_cached`` with
    ``sampling="windowed"`` for the presets' 30 steps on the graphs the
    Floyd runs used (the cached one with its cache), against the 0.8 floor,
    beside the Floyd runs' numbers."""
    for name, graph in (
            ("powerlaw_1m", pg["powerlaw_1m"]),
            ("powerlaw_1m_layer0_cached",
             results["powerlaw_1m_layer0_cached"]["trainer"].graph)):
        label = f"{name} windowed"
        with phase(f"training {label}"):
            results[label] = train_preset(name, None, main_launches,
                                          overrides={"sampling": "windowed"}, graph=graph)
            if results[label]["trainer"].model.sampling != "windowed":
                raise AssertionError(f"{label}: the model samples "
                                     f"{results[label]['trainer'].model.sampling}")
            results[label].update(check_learning(label, results[label], FLOORS[name]))
            keys = ("host_ms_per_step", "device_ms_per_step", "device_idle_share")
            for run in (name, label):
                r = results[run]
                print(f"   {run}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys)
                      + f", kernel 1 launches {r['launches']['gather_mean']}, loss "
                      f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}")


def check_full_graph_gradients() -> None:
    """One full-batch step's parameter gradients on the card against the
    CPU's, for the ``fullbatch`` model on a 2000-node power-law graph
    (kernel 3)."""
    g = power_law_graph(**{**FULLBATCH_GRAPH, "num_nodes": 2000, "num_edges": 20000})
    cfg = TrainConfig(num_steps=1, test_size=200, val_size=100, log_every=0)
    model = GraphSAGE(128, 16, (128, 128), (None, None),
                      generator=torch.Generator().manual_seed(0))
    launches = card_vs_cpu_grads(
        "fullbatch step (N=2000)", model,
        lambda m, graph: FullGraphTrainer(m, graph, cfg)._loss(), g)
    if launches != full_graph_step_launches(model):
        raise AssertionError(f"full-batch step: launched {launches}")


def time_full_graph_spmm(fb_graph, reddit, reddit_model) -> list:
    """Kernel 3 forward (normalised) and backward (unnormalised, on
    ``g / deg``) at the full-batch shapes: the ``fullbatch`` graph's layers
    (X [100000,128] f32) and ``reddit``'s full-graph layer 0 (its projected
    rows, [232965,128] bf16); beside the plain version and
    ``torch.sparse.mm``.
    Bounds as in ``time_kernels``: X and the output once, indptr, the used
    ids; operations one add per edge and element (and one scale per row);
    and, as for the cache build, with one row read per edge."""
    out = []
    with torch.no_grad():
        projected = (reddit.features @ reddit_model.layers[0].weight.to(torch.bfloat16))
    rng = np.random.default_rng(51)
    for label, g, x in (
            ("fullbatch", fb_graph, torch.from_numpy(rng.standard_normal(
                (fb_graph.num_nodes, 128), dtype=np.float32)).to(fb_graph.device)),
            ("reddit full-graph layer 0", reddit, projected.contiguous())):
        n, f = x.shape
        e = g.num_edges
        elt = x.element_size()
        deg = (g.indptr[1:] - g.indptr[:-1]).long()
        grad = torch.randn(n, f, generator=torch.Generator().manual_seed(52)).to(x.device)
        gs = (grad / deg.clamp(min=1)[:, None]).to(x.dtype)
        rows = torch.repeat_interleave(torch.arange(n, device=g.device), deg)
        vals = (1.0 / deg.clamp(min=1).float())[rows]
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            mean = torch.sparse_csr_tensor(g.indptr.long(), g.edge_dst[:e].long(),
                                           vals.to(x.dtype), size=(n, n))
            ones = torch.sparse_csr_tensor(g.indptr.long(), g.edge_dst[:e].long(),
                                           torch.ones(e, device=g.device, dtype=x.dtype),
                                           size=(n, n))
        for direction, normalize, arg, lib in (("forward", True, x, mean),
                                               ("backward on g/deg", False, gs, ones)):
            kernel = lambda: spmm_kernel.spmm_mean(arg, g.indptr, g.edge_dst, normalize)  # noqa: E731
            bd, by = bound(2 * n * f * elt + (n + 1) * 4 + e * 4, e * f + n * f * normalize)
            # The tables do not fit the 50 MB L2 once: also one row read per edge.
            per_edge, _ = bound(e * f * elt + n * f * elt + (n + 1) * 4 + e * 4, 0)
            library = library_ms(lambda: torch.sparse.mm(lib, arg),
                                 lambda: torch.sparse.mm(lib.to(torch.float32), arg.float()),
                                 f"sparse.mm {label} {direction}")
            rec = dict(
                label=f"{label} {direction}",
                shape=f"{label} {direction}: X [{n},{f}] {x.dtype}, E={e}",
                ms=device_ms(kernel, "spmm_mean_kernel"),
                plain_ms=device_ms(lambda: spmm_kernel.spmm_mean_plain(
                    arg, g.indptr, g.edge_dst, normalize)),
                library_ms=library[0], library_note=library[1],
                bound_ms=bd, bound_by=by, bound_row_per_edge_ms=per_edge,
                call_ms=call_ms(kernel, iters=20), panels=spmm_panels(arg),
            )
            out.append(rec)
            print(f"   spmm_mean [{rec['shape']}] ({rec['panels']} panel(s)): device ms: "
                  f"kernel {rec['ms']:.4f}, plain "
                  f"{rec['plain_ms']:.4f}, sparse.mm {rec['library_ms']:.4f} "
                  f"({rec['library_note']}), bound {rec['bound_ms']:.4f} "
                  f"({rec['bound_by']}), one row per edge "
                  f"{per_edge:.4f}; per call through the wrapper {rec['call_ms']:.4f} ms")
        del mean, ones, rows, vals
        torch.cuda.empty_cache()
    return out


def ppi_runs(main_launches) -> None:
    """The inductive PPI protocol at the paper's shape: train the
    multilabel model of tests/test_multilabel.py on the disjoint union of
    20 graphs, sampled (``Trainer``) and full-batch (``FullGraphTrainer``),
    and hold each to that test's bars on the 4 held-out graphs (evaluated
    over complete neighborhoods); serve one held-out graph through the table
    tier and check its multi-hot predictions against the trainer's."""
    t0 = time.perf_counter()
    graphs = synthetic_ppi_graphs(**PPI)
    train_g = disjoint_union(graphs[:PPI_TRAIN_GRAPHS])
    test_g = disjoint_union(graphs[PPI_TRAIN_GRAPHS:])
    print(f"   {len(graphs)} PPI graphs built in {time.perf_counter() - t0:.1f} s; "
          f"train {train_g}, held out {test_g}; degree mean "
          f"{float(train_g.degrees.float().mean()):.2f}")
    truth = test_g.labels.cpu().numpy()
    trivial = max(micro_f1(truth, np.ones_like(truth)), micro_f1(truth, np.zeros_like(truth)))
    eval_cfg = TrainConfig(num_steps=1, test_size=0, val_size=64, log_every=0)
    for route in ("sampled", "full-batch"):
        label = f"ppi {route}"
        with phase(f"training {label}"):
            model = GraphSAGE(50, PPI["num_classes"], generator=torch.Generator().manual_seed(0),
                              **{**PPI_MODEL, **({"fanouts": (None, None)}
                                                 if route == "full-batch" else {})})
            cfg = TrainConfig(**PPI_TRAIN)
            if route == "sampled":
                log: list[str] = []
                reset_launches()
                trainer = Trainer(model, train_g, cfg)
                result = trainer.run(log=log.append)
                result["trainer"] = trainer
                launches = read_launches()
                per_step = step_launches(model, train_g.num_nodes, cfg.batch_size)
                want = {k: PPI_STEPS * v for k, v in per_step.items()}
                want["spmm_mean"] += model.num_layers  # the full-graph evaluation
                if launches != want:
                    raise AssertionError(f"{label}: launches {launches}, want {want}")
                for kernel, count in launches.items():
                    main_launches[kernel] += count
                print(f"   {label}: {PPI_STEPS} steps, launches {launches}")
            else:
                result = train_full_graph(label, main_launches, model, train_g, cfg)
            losses = result["losses"]
            reset_launches()
            held = (FullGraphTrainer if route == "full-batch" else Trainer)(
                model, test_g, eval_cfg).evaluate(np.arange(test_g.num_nodes))
            main_launches["spmm_mean"] += read_launches()["spmm_mean"]
            host_ms = result["mean_step_time"] * 1e3
            dev_ms, top = step_device_ms(result["trainer"])
            print(f"   {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (bar: below "
                  f"{0.25 * losses[0]:.4f}); inductive micro-F1 on the {len(graphs) - PPI_TRAIN_GRAPHS}"
                  f" held-out graphs {held['micro_f1']:.4f} (bars: above {trivial + 0.2:.4f}, the "
                  f"best trivial predictor + 0.2, and 0.75); host ms per step {host_ms:.3f}, "
                  f"device ms per step {dev_ms:.4f}, idle share {1.0 - dev_ms / host_ms:.4f}; "
                  f"top {top}")
            if not (losses[-1] < 0.25 * losses[0] and held["micro_f1"] > trivial + 0.2
                    and held["micro_f1"] > 0.75):
                raise AssertionError(f"{label}: the run did not clear the PPI bars")
    # The table tier on one held-out graph against the full-batch trainer.
    g = graphs[PPI_TRAIN_GRAPHS]
    nodes = np.arange(g.num_nodes)
    reset_launches()
    served = ServingEngine(model, g).predict(nodes)
    want = FullGraphTrainer(model, g, eval_cfg)
    with torch.no_grad():
        logits = want._logits().cpu().numpy()
    want_f1 = want.evaluate(nodes)["micro_f1"]
    main_launches["spmm_mean"] += read_launches()["spmm_mean"]
    got_f1 = micro_f1(g.labels.cpu().numpy(), served)
    if served.shape != (g.num_nodes, PPI["num_classes"]) or served.dtype != np.int8:
        raise AssertionError(f"ppi serving: predictions {served.shape} {served.dtype}")
    # The head's products run at other batch sizes in the two paths and may
    # round differently: a logit within 1e-4 of 0 may fall either way.
    decided = np.abs(logits) > 1e-4
    if not np.array_equal(served[decided], model.predictions(logits)[decided]):
        raise AssertionError("ppi serving: table-tier predictions differ from the trainer's")
    if abs(got_f1 - want_f1) > (~decided).sum() / served.size:
        raise AssertionError(f"ppi serving: micro-F1 {got_f1} against the trainer's {want_f1}")
    print(f"   ppi serving: the table tier's multi-hot predictions on held-out graph "
          f"{PPI_TRAIN_GRAPHS} equal FullGraphTrainer's ({int((~decided).sum())} logits within "
          f"1e-4 of 0 left out); micro-F1 {got_f1:.4f} against evaluate's {want_f1:.4f}")


# The published Reddit graph's size (perfbench/configs/reddit.json): 232,965
# nodes, 57,307,946 undirected pairs, 114,615,892 edge slots, degree 492.
REDDIT_NODES, REDDIT_PAIRS = 232_965, 57_307_946


def reddit_degree_csr(seed: int = 17) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indptr, edge_dst)`` of a graph of the published Reddit graph's size
    and degree, drawn on the card: one end of each pair Zipf-like (exponent
    0.75 over a random order of the nodes), the other uniform, as the
    benchmark's generator draws half its ends; repeated pairs kept."""
    dev = torch.device("cuda")
    n = REDDIT_NODES
    g = torch.Generator(device=dev).manual_seed(seed)
    cdf = torch.cumsum((torch.randperm(n, generator=g, device=dev).double() + 1).pow(-0.75), 0)
    cdf /= cdf[-1].clone()
    a = torch.searchsorted(cdf, torch.rand(REDDIT_PAIRS, generator=g, device=dev,
                                           dtype=torch.float64)).clamp_(max=n - 1)
    b = torch.randint(0, n, (REDDIT_PAIRS,), generator=g, device=dev)
    src, dst = torch.cat([a, b]), torch.cat([b, a])
    del a, b, cdf
    edge_dst = dst[torch.argsort(src * n + dst)].to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return indptr, edge_dst


def time_published_reddit_spmm(check_rows: int = 4000) -> list:
    """Kernel 3 forward (normalised) and backward (unnormalised, on
    ``g / deg``) at the published Reddit model's f32 rows: X [232965, 128]
    (119 MB, 2.4x the L2) over ``reddit_degree_csr``, with its column
    panels, beside ``torch.sparse.mm`` and the bound (X once, and one row
    per edge). The plain version would gather 58.7 GB: it checks the first
    ``check_rows`` rows only, and is not timed."""
    indptr, edge_dst = reddit_degree_csr()
    n, f, e = REDDIT_NODES, 128, 2 * REDDIT_PAIRS
    rng = np.random.default_rng(53)
    x = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32)).cuda()
    deg = (indptr[1:] - indptr[:-1]).long()
    grad = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32)).cuda()
    gs = grad / deg.clamp(min=1)[:, None]
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), deg)
    out = []
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        mean = torch.sparse_csr_tensor(indptr.long(), edge_dst.long(),
                                       (1.0 / deg.clamp(min=1).float())[rows], size=(n, n))
        ones = torch.sparse_csr_tensor(indptr.long(), edge_dst.long(),
                                       torch.ones(e, device=x.device), size=(n, n))
    del rows
    head = indptr[:check_rows + 1]
    for direction, normalize, arg, lib in (("forward", True, x, mean),
                                           ("backward on g/deg", False, gs, ones)):
        kernel = lambda: spmm_kernel.spmm_mean(arg, indptr, edge_dst, normalize)  # noqa: E731
        got = kernel()[:check_rows]
        max_err(got, spmm_kernel.spmm_mean_plain(arg, head, edge_dst, normalize),
                f"spmm_mean published reddit {direction}", TOL,
                magnitude=spmm_kernel.spmm_mean_plain(arg.abs(), head, edge_dst, normalize))
        bd, by = bound(2 * n * f * 4 + (n + 1) * 4 + e * 4, e * f + n * f * normalize)
        per_edge, _ = bound(e * f * 4 + n * f * 4 + (n + 1) * 4 + e * 4, 0)
        rec = dict(
            label=f"published reddit {direction}",
            shape=f"published reddit model's rows, {direction}: X [{n},{f}] f32, E={e}",
            ms=device_ms(kernel, "spmm_mean_kernel", iters=10), plain_ms=None,
            library_ms=device_ms(lambda: torch.sparse.mm(lib, arg), iters=10),
            bound_ms=bd, bound_by=by, bound_row_per_edge_ms=per_edge,
            call_ms=call_ms(kernel, iters=10, warmup=2), panels=spmm_panels(arg))
        out.append(rec)
        print(f"   spmm_mean [{rec['shape']}] ({rec['panels']} panel(s)): device ms: kernel "
              f"{rec['ms']:.4f}, sparse.mm {rec['library_ms']:.4f}, bound {bd:.4f} ({by}), "
              f"one row per edge {per_edge:.4f}; per call through the wrapper "
              f"{rec['call_ms']:.4f} ms")
    return out


# The reddit-pool cell's pooled width (MaxPoolingAggregator, model_size
# small), and the columns planted as one value on every node: the cell's
# model leaves 53-54 of layer 1's 512 pooled columns so.
POOL_WIDTH = 512
POOL_CONSTANT_COLS = 48


@contextlib.contextmanager
def l2_of(nbytes: int):
    """The panel planner reads an L2 of ``nbytes`` for a while (``1 << 40``:
    every table takes one pass)."""
    saved = spmm_kernel.l2_bytes
    spmm_kernel.l2_bytes = lambda index: nbytes
    try:
        yield
    finally:
        spmm_kernel.l2_bytes = saved


def segment_max_panels(fn) -> int:
    """The counter ``agg.segment_max.panels`` over one call of ``fn``."""
    profiling.reset()
    profiling.enable()
    try:
        fn()
        torch.cuda.synchronize()
        counts = {e["name"]: e["args"]["value"] for e in profiling.export()["traceEvents"]
                  if e["ph"] == "C"}
    finally:
        profiling.disable()
        profiling.reset()
    return counts.get("agg.segment_max.panels", 0)


def pool_rows(n: int, f: int, seed: int) -> torch.Tensor:
    """ReLU outputs ``[n, f]`` f32 on the card with the cell's kinds of tie:
    the first ``POOL_CONSTANT_COLS`` columns one value on every node (every
    row ties with all its neighbours), the next column 0 everywhere (every
    max is 0), a third of the rest in quarter steps (ties above 0), the
    others Gaussians through the ReLU."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.relu(torch.randn((n, f), generator=g, device="cuda"))
    k = POOL_CONSTANT_COLS
    x[:, :k] = 0.5
    x[:, k] = 0.0
    q = slice(k + 1, k + 1 + (f - k - 1) // 3)
    x[:, q] = torch.round(x[:, q] * 4) / 4
    return x


def time_pool_cell_segment_max(check_rows: int = 1000) -> tuple[list, float]:
    """The segment max at the reddit-pool cell's shape: pooled rows [232965,
    512] f32 (``pool_rows``) over ``reddit_degree_csr``, symmetric as the
    cell's graph. The forward in the planner's panels and in one pass:
    bitwise equal (values and record), and on the first ``check_rows`` rows
    to the plain version (the whole plain gather is 234.7 GB); the counter
    ``agg.segment_max.panels`` of each. The backward on a gradient that is 0
    past those rows, through both routes (full ties through kernel 3, and
    through the tie pass's atomics) against the plain backward, each element
    within ``TOL`` of its terms' magnitude. Device ms (profiler) and per call
    (CUDA events) of the forward in both plans and of the backward as the
    model runs it, beside the bound (``segment_max_bytes``,
    ``segment_max_backward_bytes``) and one row read per edge. Returns the
    records and the backward's largest error."""
    indptr, edge_dst = reddit_degree_csr()
    n, f, e = REDDIT_NODES, POOL_WIDTH, 2 * REDDIT_PAIRS
    x = pool_rows(n, f, seed=59)
    head = indptr[:check_rows + 1]
    want, want_rec = smax_kernel.segment_max_plain(x, head, edge_dst)
    forward = lambda: smax_kernel._launch(x, indptr, edge_dst)  # noqa: E731
    out, rec = forward()
    panels = segment_max_panels(forward)
    with l2_of(1 << 40):
        out_1, rec_1 = forward()
        one_pass = segment_max_panels(forward)
    if panels != spmm_panels(x) or one_pass != 1:
        raise AssertionError(f"segment max panels {panels} and {one_pass}, want "
                             f"{spmm_panels(x)} and 1")
    for what, got, ref in (("one pass == panels", (out_1, rec_1), (out, rec)),
                           (f"panels == plain, first {check_rows} rows",
                            (out[:check_rows], rec[:check_rows]), (want, want_rec))):
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"segment max at the reddit-pool cell: {what} not bitwise")
    del out_1, rec_1
    gen = torch.Generator(device="cuda").manual_seed(61)
    g = torch.zeros_like(x)
    g[:check_rows] = torch.randn((check_rows, f), generator=gen, device="cuda")
    plain = smax_kernel.segment_max_backward_plain(g[:check_rows], x, want, want_rec, head,
                                                   edge_dst)
    size = smax_kernel.segment_max_backward_plain(g[:check_rows].abs(), x, want, want_rec,
                                                  head, edge_dst)
    err = 0.0
    for symmetric in (True, False):
        got = smax_kernel._launch_backward(g, x, out, rec, indptr, edge_dst, symmetric=symmetric)
        route = "full ties through kernel 3" if symmetric else "full ties in the tie pass"
        err = max(err, max_err(got, plain, f"segment max backward at the reddit-pool cell, "
                               f"{route}", TOL, magnitude=size))
    del plain, size, want, want_rec, got
    g = torch.randn((n, f), generator=gen, device="cuda")
    backward = functools.partial(smax_kernel._launch_backward, g, x, out, rec, indptr, edge_dst,
                                 symmetric=True)
    fwd_bound = bound(smax_kernel.segment_max_bytes(n, f, 4, e), e * f)
    per_edge, _ = bound(e * f * 4 + smax_kernel.segment_max_bytes(n, f, 4, e) - n * f * 4, 0)
    records = []
    for label, l2, fn, (bd, by), row_per_edge in (
            ("reddit-pool cell forward", None, forward, fwd_bound, per_edge),
            ("reddit-pool cell forward, one pass", 1 << 40, forward, fwd_bound, per_edge),
            ("reddit-pool cell backward", None, backward,
             bound(smax_kernel.segment_max_backward_bytes(n, f, 4), 0), None)):
        with l2_of(l2) if l2 is not None else contextlib.nullcontext():
            rec_ = dict(
                label=label, shape=f"{label}: X [{n},{f}] f32, E={e}, "
                f"{POOL_CONSTANT_COLS} columns tied in full",
                ms=device_ms(fn, None if "backward" in label else "segment_max_kernel",
                             iters=10),
                plain_ms=None, library_ms=None, bound_ms=bd, bound_by=by,
                bound_row_per_edge_ms=row_per_edge, call_ms=call_ms(fn, iters=10, warmup=2),
                panels=one_pass if l2 is not None else panels)
        records.append(rec_)
        print(f"   segment_max [{rec_['shape']}] ({rec_['panels']} panel(s)): device ms "
              f"{rec_['ms']:.4f}, per call (CUDA events) {rec_['call_ms']:.4f}, bound "
              f"{bd:.4f} ({by})" + (f", one row per edge {row_per_edge:.4f}"
                                   if row_per_edge is not None else ""))
    print(f"   segment max at the reddit-pool cell: forward bitwise in {panels} panels and "
          f"in one pass, and the plain version's on {check_rows} rows; backward within "
          f"{TOL} of the terms' magnitude on both routes (largest error {err:.3g})")
    del x, g, out, rec, indptr, edge_dst
    torch.cuda.empty_cache()
    return records, err


def samplers_full_batch_multilabel(pg, pubmed, pubmed_root, results, timings,
                                   main_launches) -> None:
    """The phases of the windowed sampler, full-batch training and the
    multilabel head, on the reduced-precision phases' graphs (``pg``) and
    runs (``results``); kernel 3's new timing rows go into ``timings``."""
    windowed_runs(pg, results, main_launches)
    with phase("sampling stage by method"):
        sampling_stage_ms(pg, pubmed)
    with phase("data: the fullbatch graph"):
        fb_graph = power_law_graph(**FULLBATCH_GRAPH)
        print(f"   fullbatch: {fb_graph}; degree max {int(fb_graph.degrees.max())}")
    with phase("training fullbatch (FullGraphTrainer)"):
        fb_model = GraphSAGE(128, 16, (128, 128), (None, None),
                             generator=torch.Generator().manual_seed(0))
        results["fullbatch"] = train_full_graph(
            "fullbatch", main_launches, fb_model, fb_graph, TrainConfig(num_steps=40))
        results["fullbatch"].update(check_learning("fullbatch", results["fullbatch"],
                                                   FULLBATCH_FLOOR))
    with phase("training pubmed, mode='full-graph'"):
        results["pubmed full-graph"] = train_full_graph(
            "pubmed full-graph", main_launches, preset="pubmed", root=pubmed_root)
        results["pubmed full-graph"].update(
            check_learning("pubmed full-graph", results["pubmed full-graph"]))
    with phase("training reddit, mode='full-graph'"):
        cfg = preset_config("reddit", {"fanouts": (None, None)})
        results["reddit full-graph"] = train_full_graph(
            "reddit full-graph", main_launches, build_model(cfg, pg["reddit"]),
            pg["reddit"], cfg.train)
        results["reddit full-graph"].update(
            check_learning("reddit full-graph", results["reddit full-graph"]))
    with phase("full-batch gradients, card against CPU"):
        check_full_graph_gradients()
    with phase("timings, kernel 3 at the full-batch shapes"):
        timings["spmm_mean"] += time_full_graph_spmm(
            fb_graph, pg["reddit"], results["reddit full-graph"]["trainer"].model)
    del fb_graph
    torch.cuda.empty_cache()
    with phase("timings, kernel 3 at the published reddit model's rows"):
        timings["spmm_mean"] += time_published_reddit_spmm()
    torch.cuda.empty_cache()
    with phase("multilabel: PPI, sampled and full-batch"):
        ppi_runs(main_launches)


# ------------------------------------- unsupervised, checkpoints, inductive
# The bars of tests/test_unsupervised.py (the geometry test): the mean of
# the last 10 losses below the first 10's minus 0.3, mean embedding norm
# above 0.05, edge endpoints' cosine above random pairs' + 0.2, the probe's
# validation micro-F1 above 1 / C + 0.2.
UNSUP_BARS = dict(loss_drop=0.3, min_norm=0.05, cos_margin=0.2, probe_margin=0.2)
# tests/test_inductive.py: unseen nodes' micro-F1 above 0.75 at 5 classes,
# chance + 0.55. The stand-in trains at lr 0.1 (see PRESET_OF) for the
# Pubmed preset's 200 steps.
INDUCTIVE_MARGIN = 0.55
INDUCTIVE_OVERRIDES = {"learning_rate": 0.1, "num_steps": 200}
# A resumed run on the card against an uninterrupted one: kernel 2 sums
# with atomics in an order that changes from run to run, so the two differ
# by rounding, which the steps carry on (measured in PERF.md §6).
RESUME_RTOL = 1e-4


def sm_clock() -> str:
    """The card's SM clock now, as ``nvidia-smi`` reads it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def unsup_groups(model, graph, seeds, q, seed):
    """The graph-context groups of ``seeds`` and their sampled frontier, on
    the graph's device."""
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    cdf = torch.from_numpy(negative_cdf(graph.degrees.cpu().numpy())).to(graph.device)
    groups, pair_mask = context_groups(gen, graph, seeds, cdf, walk_length=3,
                                       num_negatives=q)
    return model.sample(gen, graph, groups), pair_mask


def train_cora_unsup(root, main_launches) -> dict:
    """``run_preset("cora_unsup")`` at full width: every step launches
    kernels 1 and 2 once (layer 0 projects first at 3072 group seeds), the
    one evaluation kernel 3 once per layer (the probe's full-graph
    embeddings); the bars; host and device ms per step; the probe."""
    cfg = preset_config("cora_unsup")
    steps, log = cfg.train.num_steps, []
    reset_launches()
    result = run_preset("cora_unsup", data_root=root, log=log.append)
    launches = read_launches()
    tr = result["trainer"]
    model, graph = tr.model, tr.graph
    groups = cfg.train.batch_size * (2 + cfg.train.num_negatives)
    slots = layer0_slots(model, groups)
    want = {k: 0 for k in KERNELS}
    want.update(gather_mean=steps, spmm_mean=model.num_layers, scatter_mean=steps * int(
        model.sampled_layer0_project_first(graph.num_nodes, slots)))
    print(f"   cora_unsup: {steps} steps of {groups} group seeds ({slots} layer-0 "
          f"slots), launches {launches}; {log[-2]}; {log[-1]}")
    if launches != want or want["scatter_mean"] != steps:
        raise AssertionError(f"cora_unsup: launches {launches}, want {want}")
    for k, n in launches.items():
        main_launches[k] += n
    losses = np.asarray(result["losses"])
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"cora_unsup: losses {losses}")
    with torch.no_grad():
        emb = model.embed_full_graph(graph).cpu().numpy()
    norms = np.linalg.norm(emb, axis=1)
    z = emb / (norms[:, None] + 1e-8)
    e = graph.num_edges
    src, dst = graph.edge_src[:e].cpu().numpy(), graph.edge_dst[:e].cpu().numpy()
    rng = np.random.default_rng(0)
    ri, rj = rng.integers(0, graph.num_nodes, 4000), rng.integers(0, graph.num_nodes, 4000)
    stats = dict(loss_first10=float(losses[:10].mean()), loss_last10=float(losses[-10:].mean()),
                 mean_norm=float(norms.mean()), edge_cos=float((z[src] * z[dst]).sum(-1).mean()),
                 random_cos=float((z[ri] * z[rj]).sum(-1).mean()),
                 probe_val_micro_f1=result["val_micro_f1"], chance=1.0 / graph.num_classes)
    head0 = build_model(cfg, graph).head
    stats["head_unchanged"] = bool(model.head.grad is None and torch.equal(model.head, head0))
    bars = UNSUP_BARS
    held = dict(
        loss=stats["loss_last10"] < stats["loss_first10"] - bars["loss_drop"],
        norm=stats["mean_norm"] > bars["min_norm"],
        cos=stats["edge_cos"] > stats["random_cos"] + bars["cos_margin"],
        probe=stats["probe_val_micro_f1"] > stats["chance"] + bars["probe_margin"],
        head=stats["head_unchanged"])
    print(f"   cora_unsup: {stats}; bars {bars}: held {held}")
    if not all(held.values()):
        raise AssertionError(f"cora_unsup: bars missed: {held}")
    reset_launches()
    _, probe_ms = timed(lambda: tr.predict(tr.val_nodes))
    probe_launches = read_launches()
    if probe_launches["spmm_mean"] != model.num_layers or sum(probe_launches.values()) != \
            model.num_layers:
        raise AssertionError(f"cora_unsup probe: launches {probe_launches}")
    host_ms = result["mean_step_time"] * 1e3
    # Three profiles, each beside the SM clock: the device ms of this step
    # differed 2x between two calls on the same code while every other
    # step's agreed.
    profiles = [(sm_clock(), *step_device_ms(tr)) for _ in range(3)]
    dev_ms, top = float(np.median([p[1] for p in profiles])), profiles[-1][2]
    stats.update(host_ms_per_step=host_ms, device_ms_per_step=dev_ms,
                 device_idle_share=1.0 - dev_ms / host_ms, top_kernels=top,
                 probe_host_ms=probe_ms, probe_launches=probe_launches)
    print(f"   cora_unsup: host ms per step {host_ms:.3f}, device ms per step "
          f"{dev_ms:.4f} (median of {[round(p[1], 4) for p in profiles]} at SM clocks "
          f"{[p[0] for p in profiles]}), idle share {1.0 - dev_ms / host_ms:.3f}, top "
          f"kernels {top}; the probe (one predict, 300 Adam steps): {probe_ms:.1f} "
          f"host ms, launches {probe_launches}")
    result.update(stats)
    return result


def check_memory(graph) -> None:
    """``utils/memory`` on the card: the live total holds at least the
    graph's arrays, the largest live block at least its feature table."""
    stats = memory.live_device_bytes(device=graph.device)
    largest = memory.max_live_buffer_bytes(device=graph.device)
    print(f"   live device bytes {stats['per_device_bytes']}, largest live block "
          f"{largest}; the cora_unsup graph holds {graph.nbytes}, its table "
          f"{graph.features.nbytes}")
    if stats["total_bytes"] < graph.nbytes or largest < graph.features.nbytes:
        raise AssertionError("utils/memory reports less than the graph holds")


def unsup_frontier_loss(model, graph, frontier, pair_mask):
    return frontier_loss(model, graph, frontier, pair_mask,
                         PRESETS["cora_unsup"].train.num_negatives)


def check_unsup_gradients(graph) -> None:
    """Card against CPU gradients of the graph-context loss of a fresh
    ``cora_unsup`` model on one set of groups and their frontier, on Cora
    with an isolated node appended and drawn as a seed (its group drops out
    of the mean; every gradient stays finite). The head gets none."""
    dev = graph.device
    lone = build_graph(np.random.default_rng(8).random((1, graph.num_features)),
                       np.zeros(1), np.zeros((0, 2), np.int64),
                       num_classes=graph.num_classes, device=dev)
    g = disjoint_union([graph, lone])
    model = build_model(preset_config("cora_unsup"), g)
    seeds = torch.arange(256, dtype=torch.int32, device=dev)
    seeds[-1] = g.num_nodes - 1
    frontier, pair_mask = unsup_groups(model, g, seeds, PRESETS["cora_unsup"].train.num_negatives,
                                       seed=13)
    if bool(pair_mask[-1]) or not bool(pair_mask[:-1].all()):
        raise AssertionError(f"pair mask {pair_mask}: the isolated seed must drop out")
    launches = card_vs_cpu_grads("cora_unsup graph-context loss", model, unsup_frontier_loss,
                                 g, frontier, pair_mask, no_grad=("head",))
    want = {k: int(k in ("gather_mean", "scatter_mean")) for k in KERNELS}
    if launches != want:
        raise AssertionError(f"cora_unsup: one step launched {launches}, want {want}")


def time_unsup_frontier(trainer, timings) -> None:
    """Kernels 1 and 2 at ``cora_unsup``'s layer-0 frontier (the projected
    table [2708,128] f32; 256 seeds' 3072 group seeds, 30720 rows of 10
    slots), in ``time_kernels``' form; appended to ``timings``."""
    model, graph = trainer.model, trainer.graph
    seeds = torch.from_numpy(next(trainer.batches())).to(graph.device)
    fr, _ = unsup_groups(model, graph, seeds, trainer.cfg.num_negatives, seed=3)
    n_out = fr.ids[1].numel()
    idx = fr.ids[2].reshape(n_out, -1).contiguous()
    mask = fr.masks[2].reshape(n_out, -1).contiguous()
    with torch.no_grad():
        table = (graph.features @ model.layers[0].weight).contiguous()
    max_err(gm_kernel.gather_mean(table, idx, mask),
            gm_kernel.gather_mean_plain(table, idx, mask), "gather_mean cora_unsup")
    st = slot_stats(idx, mask)
    recs = {"gather_mean": [gather_record("cora_unsup", "cora_unsup sampled layer 0",
                                          table, idx, mask, st)],
            "scatter_mean": [scatter_record("cora_unsup",
                                            "cora_unsup training layer-0 backward",
                                            table, idx, mask, st)]}
    print_records(recs)
    for name, r in recs.items():
        timings[name] += r


def checkpoint_resume(root, main_launches) -> None:
    """``cora`` through ``run_preset``: 100 steps straight (a snapshot every
    25), against 50 steps, a checkpoint, a fresh trainer resumed from it for
    50 more; then the CLI's ``--eval-only`` from the straight run's
    checkpoint."""
    ck = os.path.join(REPO, "build", "chip_smoke", "checkpoints")
    shutil.rmtree(ck, ignore_errors=True)
    straight_ck, half_ck = os.path.join(ck, "straight"), os.path.join(ck, "half")
    half = {"num_steps": 50}
    reset_launches()
    straight = run_preset("cora", root, log=None, checkpoint_path=straight_ck,
                          checkpoint_every=25)
    first = run_preset("cora", root, log=None, overrides=half, checkpoint_path=half_ck)
    resumed = run_preset("cora", root, log=None, overrides=half, resume_path=half_ck)
    launches = read_launches()
    model = straight["trainer"].model
    per_step = step_launches(model, straight["trainer"].graph.num_nodes,
                             PRESETS["cora"].train.batch_size)
    evals = eval_launches(model, PRESETS["cora"].train)
    want = {k: 200 * per_step[k] + 3 * evals[k] for k in KERNELS}
    if launches != want:
        raise AssertionError(f"checkpoint and resume: launches {launches}, want {want}")
    for k, n in launches.items():
        main_launches[k] += n
    tail, want_tail = np.asarray(resumed["losses"]), np.asarray(straight["losses"][50:])
    loss_diff = float(np.max(np.abs(tail - want_tail) / np.abs(want_tail)))
    same_head = first["losses"] == straight["losses"][:50]
    param_diff = {}
    with torch.no_grad():
        for (name, p), q in zip(model.named_parameters(),
                                resumed["trainer"].model.parameters()):
            param_diff[name] = float((p - q).abs().max() / p.abs().max())
    print(f"   cora, 100 steps straight against 50 + resume + 50: the first 50 "
          f"losses equal: {same_head}; the last 50: largest relative difference "
          f"{loss_diff:.3g}; final parameters, largest |difference| over the leaf's "
          f"largest entry: {param_diff}; resumed trainer at step "
          f"{resumed['trainer'].step_count}")
    np.testing.assert_allclose(tail, want_tail, rtol=RESUME_RTOL,
                               err_msg="resumed losses != uninterrupted losses")
    if max(param_diff.values()) > RESUME_RTOL or resumed["trainer"].step_count != 100:
        raise AssertionError(f"resumed parameters differ: {param_diff}")
    files = sorted(os.listdir(ck))
    state = restore_checkpoint(straight_ck, straight["trainer"].state_dict())
    print(f"   checkpoint files {files}; the straight run's at step {int(state['step'])}")
    if files != ["half.pt", "straight.pt"] or int(state["step"]) != 100:
        raise AssertionError(f"checkpoint files {files}, step {int(state['step'])}")
    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        train_main(["--preset", "cora", "--data-root", root, "--resume", straight_ck,
                    "--eval-only"])
    for k, n in read_launches().items():
        main_launches[k] += n
    lines = out.getvalue().splitlines()
    val = next(float(ln.split(": ")[1]) for ln in lines if ln.startswith("Validation F1: "))
    print(f"   --eval-only: {lines}; the trained run's validation F1 "
          f"{straight['val_micro_f1']}")
    if val != straight["val_micro_f1"] or not lines[-1].startswith("Test F1: "):
        raise AssertionError("--eval-only does not reproduce the trained run's F1")


def inductive(full, main_launches) -> None:
    """The inductive protocol of ``tests/test_inductive.py`` at the
    heavy-tailed Pubmed-sized stand-in: the ``cora`` preset's model trained
    on the subgraph induced by the first 70% of the nodes, then served on
    the full graph through the table tier (kernel 3 once per layer) for the
    held-out 30%."""
    n_train = int(0.7 * full.num_nodes)
    sub = induced_subgraph(full, np.arange(n_train))
    print(f"   induced subgraph of the first {n_train} nodes: {sub}")
    result = train_preset("cora", None, main_launches, overrides=INDUCTIVE_OVERRIDES,
                          graph=sub)
    model = result["trainer"].model
    unseen = np.arange(n_train, full.num_nodes)
    def serve():
        engine = ServingEngine(model, full)
        return engine, engine.predict(unseen)

    reset_launches()
    (eng, preds), ms = timed(serve)
    launches = read_launches()
    want = {k: model.num_layers * int(k == "spmm_mean") for k in KERNELS}
    if launches != want:
        raise AssertionError(f"inductive serving: launches {launches}, want {want}")
    main_launches["spmm_mean"] += launches["spmm_mean"]
    truth = full.labels.cpu().numpy()
    f1 = micro_f1(truth[unseen], preds)
    seen = micro_f1(truth[:n_train], eng.predict(np.arange(n_train)))
    bar = 1.0 / full.num_classes + INDUCTIVE_MARGIN
    host_ms = result["mean_step_time"] * 1e3
    dev_ms, _ = step_device_ms(result["trainer"])
    print(f"   inductive: {len(unseen)} unseen nodes, micro-F1 {f1:.4f} (bar: above "
          f"{bar:.4f}); seen nodes {seen:.4f}; engine and answers in {ms:.1f} host ms, "
          f"launches {launches}; training: last loss {result['losses'][-1]:.4f}, host "
          f"ms per step {host_ms:.3f}, device ms per step {dev_ms:.4f}, idle share "
          f"{1.0 - dev_ms / host_ms:.3f}")
    if not f1 > bar:
        raise AssertionError(f"inductive: unseen micro-F1 {f1} below {bar}")


def unsupervised_checkpoint_inductive(graphs, roots, results, timings,
                                      main_launches) -> None:
    """The phases of unsupervised training, checkpoints and resume, and
    inductive serving."""
    with phase("training cora_unsup"):
        results["cora_unsup"] = train_cora_unsup(roots["cora"], main_launches)
    with phase("utils/memory on the card"):
        check_memory(results["cora_unsup"]["trainer"].graph)
    with phase("cora_unsup gradients, card against CPU"):
        check_unsup_gradients(graphs["cora"])
    with phase("timings, kernels 1 and 2 at cora_unsup's frontier"):
        time_unsup_frontier(results["cora_unsup"]["trainer"], timings)
    with phase("checkpoint and resume, cora"):
        checkpoint_resume(roots["cora"], main_launches)
    with phase("inductive: pubmed heavy-tailed, 70% seen"):
        inductive(graphs["pubmed heavy-tailed"], main_launches)


# The parallel phase: steps of each sharded run (its single-device twin runs
# as many), and the ShardedTrainer's steps against the Trainer's.
PARALLEL_STEPS = 40
TP_STEPS = 5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_step_launches(model, steps: int) -> dict:
    """Launches of a node-sharded run of ``steps`` steps and one sampled
    evaluation (a mean model without ``concat_self``): each step's owner
    side runs kernel 1's sum mode forward (the neighbour mean of a sampled
    layer 0 that projects first, or the cache rows of a cached one) and,
    for the sampled layer 0, kernel 2's backward; the evaluation runs kernel
    1's once. A cached run builds its cache on the card, kernel 3 once."""
    want = {name: 0 for name in KERNELS}
    want["gather_mean"] = want["gather_mean_sum"] = steps + 1
    if model.layer0 == "cached":
        want["spmm_mean"] = 1
    else:
        want["scatter_mean"] = want["scatter_mean_sum"] = steps
    return want


def sharded_run(name, root, main_launches) -> dict:
    """``name``'s preset trained by ``ShardedFeatureTrainer`` in the world of
    one (NCCL), counters set to 0 just before and read just after, against
    the single-device ``Trainer`` from the same seed, step for step
    (``RESUME_RTOL``: kernel 2's atomic order); the learning bar; host ms,
    device ms, NCCL's device ms and the launches per step; memory_stats."""
    cfg = preset_config(name, {"num_steps": PARALLEL_STEPS})
    host = load_dataset(cfg.dataset, root, "cpu")
    reset_launches()
    sharded = ShardedFeatureTrainer(build_model(cfg, host, "cuda"), host, cfg.train,
                                    make_mesh({"data": 1}))
    result = sharded.run(log=None)
    launches = read_launches()
    want = sharded_step_launches(sharded.model, PARALLEL_STEPS)
    if launches != want:
        raise AssertionError(f"sharded {name}: launches {launches}, want {want}")
    for kernel, count in launches.items():
        main_launches[kernel] += count
    result["trainer"] = sharded
    dev_graph = host.to("cuda")
    single_trainer = Trainer(build_model(cfg, dev_graph), dev_graph, cfg.train)
    single = single_trainer.run(log=None)
    np.testing.assert_allclose(result["losses"], single["losses"], rtol=RESUME_RTOL,
                               err_msg=f"sharded {name} != single-device {name}")
    diff = np.max(np.abs(np.asarray(result["losses"]) - single["losses"])
                  / np.abs(single["losses"]))
    stats = check_learning(f"sharded {name}", result)
    seeds = next(sharded.batches())
    by_name = device_profile(lambda: sharded.step(seeds), iters=10)
    single_ms, _ = step_device_ms(single_trainer)
    # NCCL's kernels, and the copies a world of one's collectives may become.
    nccl = {short_name(k): v for k, v in by_name.items()
            if "nccl" in k.lower() or "memcpy" in k.lower()}
    per_step = {k: v / PARALLEL_STEPS for k, v in launches.items() if v}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"   sharded {name}: {PARALLEL_STEPS} losses within {diff:.3g} (relative) of "
          f"the single-device run's ({single['losses'][0]:.4f} -> "
          f"{single['losses'][-1]:.4f}); per step: host ms "
          f"{stats['host_ms_per_step']:.3f} (single {single['mean_step_time'] * 1e3:.3f}), "
          f"device ms {sum(by_name.values()):.4f} (single {single_ms:.4f}), of it NCCL "
          f"and copies {sum(nccl.values()):.4f} {nccl}; {len(by_name)} kernel names, top "
          f"{[(short_name(k), round(v, 5)) for k, v in top]}; launches per step (with the "
          f"evaluation's) {per_step}")
    print(f"   sharded {name} memory_stats: {sharded.memory_stats()}")
    return dict(stats, nccl_ms=sum(nccl.values()), single_device_ms=single_ms,
                launches=launches, losses=result["losses"], single_losses=single["losses"],
                single_host_ms=single["mean_step_time"] * 1e3)


COMPACT_STEPS = 40
LADDER_SLACK = 0.25
LADDER_STEPS = 3
COVER_STEPS = 5
FULLY_STEPS = 40
HUB_ROWS = 256
HUB_RTOL = 1e-6
# Kernels 1 and 2 in their mean modes over the compact exchange's answer
# buffer: their launches on the compact path are counted apart.
COMPACT_KERNELS = {"gather_mean_compact": "gather_mean", "scatter_mean_compact": "scatter_mean"}


def mean_mode(launches: dict) -> dict:
    """Kernel 1's and 2's mean-mode launches in ``launches`` (every launch
    of theirs less those of their sum modes)."""
    return {"gather_mean_compact": launches["gather_mean"] - launches["gather_mean_sum"],
            "scatter_mean_compact": launches["scatter_mean"] - launches["scatter_mean_sum"]}


def compact_step_launches(model, shard_rows: int, batch: int, steps: int, evals: int) -> dict:
    """Launches of ``steps`` compact steps and ``evals`` sampled
    evaluations of a sampled mean model in a world of one: kernel 1's mean
    mode over the answer buffer once per forward; when layer 0 projects
    first, kernel 2's mean mode into the buffer's gradient and its sum mode
    into the shard's once per step (a frozen table has no backward)."""
    want = {name: 0 for name in KERNELS}
    pf = model.sampled_layer0_project_first(shard_rows, layer0_slots(model, batch))
    want["gather_mean"] = steps + evals
    want["scatter_mean"] = 2 * steps * pf
    want["scatter_mean_sum"] = steps * pf
    return want


def relative_gap(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / np.abs(want)))


def collective_ms(by_name: dict) -> float:
    """Device ms of the collectives in a profile: NCCL's kernels, and the
    copies a world of one's collectives become."""
    return sum(v for k, v in by_name.items() if "nccl" in k.lower() or "memcpy" in k.lower())


def compact_run(name, root, dense, main_launches, compact_launches) -> dict:
    """``name``'s preset through ``ShardedFeatureTrainer(gather_mode=
    "compact")`` in the world of one, counters set to 0 just before and read
    just after, against the dense and single-device runs from the same seed
    (``dense``, :func:`sharded_run`'s record): the losses' largest relative
    gap, the learning bar, host and device ms, the collectives' share of
    the device time, launches by mode and ``sharded_comm_stats``."""
    cfg = preset_config(name, {"num_steps": COMPACT_STEPS})
    host = load_dataset(cfg.dataset, root, "cpu")
    reset_launches()
    tr = ShardedFeatureTrainer(build_model(cfg, host, "cuda"), host, cfg.train,
                               make_mesh({"data": 1}), gather_mode="compact")
    result = tr.run(log=None)
    launches = read_launches()
    want = compact_step_launches(tr.model, tr.features.rows_per_shard, cfg.train.batch_size,
                                 COMPACT_STEPS, 1)
    if launches != want:
        raise AssertionError(f"compact {name}: launches {launches}, want {want}")
    for kernel, count in launches.items():
        main_launches[kernel] += count
    for kernel, count in mean_mode(launches).items():
        compact_launches[kernel] += count
    np.testing.assert_allclose(result["losses"], dense["single_losses"], rtol=RESUME_RTOL,
                               err_msg=f"compact {name} != single-device {name}")
    result["trainer"] = tr
    stats = check_learning(f"compact {name}", result)
    seeds = next(tr.batches())
    by_name = device_profile(lambda: tr.step(seeds), iters=10)
    coll = collective_ms(by_name)
    dev = sum(by_name.values())
    batch = cfg.train.batch_size
    comm = {s: sharded_comm_stats(tr.model, batch, s, slack=tr.capacity_slack)
            for s in (1, 8)}
    print(f"   compact {name}: {COMPACT_STEPS} losses within "
          f"{relative_gap(result['losses'], dense['single_losses']):.3g} of the single-device "
          f"run's and {relative_gap(result['losses'], dense['losses']):.3g} of the dense "
          f"run's (relative); per step: host ms {stats['host_ms_per_step']:.3f} (dense "
          f"{dense['host_ms_per_step']:.3f}, single {dense['single_host_ms']:.3f}), device "
          f"ms {dev:.4f} (dense {dense['device_ms_per_step']:.4f}, single "
          f"{dense['single_device_ms']:.4f}), of it the collectives {coll:.4f} "
          f"({coll / dev:.1%}); launches by mode: mean {mean_mode(launches)}, sum "
          f"{ {k: launches[k] for k in ('gather_mean_sum', 'scatter_mean_sum')} }")
    for s, st in comm.items():
        print(f"   compact {name} sharded_comm_stats at S = {s}: {st}")
    return dict(stats, losses=result["losses"], device_ms=dev, collective_ms=coll,
                launches=launches, trainer=tr)


def ladder(root, compact) -> None:
    """``cora`` compact at ``capacity_slack=0.25``: in a world of one every
    request goes to rank 0, so slacks 0.25 and 0.5 overflow (capacity 6400
    and 12800 against 25600 requests) and 1.0 fits. Each step warns twice,
    then applies; its losses equal the compact run's. The ladder's cost:
    host and device ms of its step against the compact step's."""
    cfg = preset_config("cora", {"num_steps": LADDER_STEPS})
    host = load_dataset("cora", root, "cpu")
    tr = ShardedFeatureTrainer(build_model(cfg, host, "cuda"), host, cfg.train,
                               make_mesh({"data": 1}), gather_mode="compact",
                               capacity_slack=LADDER_SLACK)
    it = tr.batches()
    losses, times = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(LADDER_STEPS):
            seeds = next(it)
            t0 = time.perf_counter()
            losses.append(float(tr.step(seeds)))
            times.append((time.perf_counter() - t0) * 1e3)
    said = [str(w.message) for w in caught if "capacity" in str(w.message)]
    if len(said) != 2 * LADDER_STEPS or tr.step_count != LADDER_STEPS:
        raise AssertionError(f"ladder: {len(said)} warnings, {tr.step_count} steps: {said}")
    np.testing.assert_allclose(losses, compact["losses"][:LADDER_STEPS], rtol=RESUME_RTOL,
                               err_msg="ladder losses != the compact run's")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dev = sum(device_profile(lambda: tr.step(seeds), iters=5).values())
    print(f"   ladder: {LADDER_STEPS} steps at slack {LADDER_SLACK}, each warned twice "
          f"({said[0][:60]}...; {said[1][:60]}...) then applied; losses "
          f"{np.round(losses, 6).tolist()} within {relative_gap(losses, compact['losses'][:LADDER_STEPS]):.3g} "
          f"of the compact run's; a ladder step: host ms {np.round(times, 3).tolist()} "
          f"(the compact step {compact['host_ms_per_step']:.3f}), device ms {dev:.4f} "
          f"(compact {compact['device_ms']:.4f})")


def hub_runs(graph, main_launches) -> None:
    """``pubmed_layer0_cached`` (pure mean: the cache rows through the
    compact row gather) on the heavy-tailed stand-in at lr 0.1, compact,
    with and without ``hub_cache_rows=256``: the losses agree within
    ``HUB_RTOL``; kernel 3 builds each run's cache once and nothing else
    launches."""
    host = graph.to("cpu")
    cfg = preset_config("pubmed_layer0_cached", {"num_steps": COMPACT_STEPS,
                                                 "learning_rate": 0.1})
    runs = {}
    for rows in (0, HUB_ROWS):
        reset_launches()
        tr = ShardedFeatureTrainer(build_model(cfg, host, "cuda"), host, cfg.train,
                                   make_mesh({"data": 1}), gather_mode="compact",
                                   hub_cache_rows=rows)
        result = tr.run(log=None)
        launches = read_launches()
        if launches != {**{k: 0 for k in KERNELS}, "spmm_mean": 1}:
            raise AssertionError(f"hub {rows}: launches {launches}")
        for kernel, count in launches.items():
            main_launches[kernel] += count
        seeds = next(tr.batches())
        dev = sum(device_profile(lambda: tr.step(seeds), iters=10).values())
        runs[rows] = dict(losses=result["losses"], host_ms=result["mean_step_time"] * 1e3,
                          device_ms=dev, val=result["val_micro_f1"],
                          hub_bytes=tr.memory_stats()["hub_cache_bytes_per_chip"])
    np.testing.assert_allclose(runs[HUB_ROWS]["losses"], runs[0]["losses"], rtol=HUB_RTOL,
                               err_msg="hub-cache losses != the routed run's")
    frac = hub_request_fraction(host.degrees, HUB_ROWS)
    print(f"   hub cache, pubmed_layer0_cached on the stand-in (max degree "
          f"{int(host.degrees.max())}): hub_request_fraction({HUB_ROWS}) = {frac:.4f}; "
          f"{COMPACT_STEPS} losses within {relative_gap(runs[HUB_ROWS]['losses'], runs[0]['losses']):.3g} "
          f"(relative) of the run without it ({runs[0]['losses'][0]:.4f} -> "
          f"{runs[0]['losses'][-1]:.4f}); per step host ms {runs[0]['host_ms']:.3f} without, "
          f"{runs[HUB_ROWS]['host_ms']:.3f} with; device ms {runs[0]['device_ms']:.4f} "
          f"without, {runs[HUB_ROWS]['device_ms']:.4f} with; hub bytes "
          f"{runs[HUB_ROWS]['hub_bytes']}; val micro-F1 {runs[0]['val']:.4f}, "
          f"{runs[HUB_ROWS]['val']:.4f}")


def fully_sharded_run(name, root, main_launches, compact_launches) -> dict:
    """``FullyShardedTrainer`` in the world of one: ``COVER_STEPS`` steps at
    covering fanouts equal to ``ShardedFeatureTrainer``'s (``RESUME_RTOL``),
    then ``FULLY_STEPS`` steps at the preset's fanouts, counters set to 0
    just before and read just after, over the learning bar; its
    ``memory_stats``."""
    host = load_dataset(PRESETS[name].dataset, root, "cpu")
    cover = int(host.neighbors.shape[1])  # the ELL width: no draw at all
    mesh = make_mesh({"data": 1})
    cov = preset_config(name, {"num_steps": COVER_STEPS,
                               "fanouts": (cover,) * len(PRESETS[name].model.fanouts)})
    got = {}
    for cls in (FullyShardedTrainer, ShardedFeatureTrainer):
        tr = cls(build_model(cov, host, "cuda"), host, cov.train, mesh)
        it = tr.batches()
        got[cls.__name__] = [float(tr.step(next(it))) for _ in range(COVER_STEPS)]
    np.testing.assert_allclose(got["FullyShardedTrainer"], got["ShardedFeatureTrainer"],
                               rtol=RESUME_RTOL,
                               err_msg=f"fully sharded {name} != node-sharded at covering fanouts")
    cfg = preset_config(name, {"num_steps": FULLY_STEPS})
    reset_launches()
    tr = FullyShardedTrainer(build_model(cfg, host, "cuda"), host, cfg.train, mesh)
    result = tr.run(log=None)
    launches = read_launches()
    if tr.model.layer0 == "cached":
        want = {**{k: 0 for k in KERNELS}, "spmm_mean": 1}
    else:
        want = compact_step_launches(tr.model, tr.features.rows_per_shard,
                                     cfg.train.batch_size, FULLY_STEPS, 1)
    if launches != want:
        raise AssertionError(f"fully sharded {name}: launches {launches}, want {want}")
    for kernel, count in launches.items():
        main_launches[kernel] += count
    for kernel, count in mean_mode(launches).items():
        compact_launches[kernel] += count
    result["trainer"] = tr
    stats = check_learning(f"fully sharded {name}", result)
    seeds = next(tr.batches())
    by_name = device_profile(lambda: tr.step(seeds), iters=10)
    dev, coll = sum(by_name.values()), collective_ms(by_name)
    print(f"   fully sharded {name}: covering fanout {cover}, {COVER_STEPS} losses within "
          f"{relative_gap(got['FullyShardedTrainer'], got['ShardedFeatureTrainer']):.3g} of "
          f"the node-sharded run's; preset fanouts: device ms {dev:.4f}, of it the "
          f"collectives {coll:.4f} ({coll / dev:.1%}); launches {launches}")
    print(f"   fully sharded {name} memory_stats: {tr.memory_stats()}")
    print(f"   fully sharded {name} sharded_comm_stats at S = 8: "
          f"{sharded_comm_stats(tr.model, cfg.train.batch_size, 8, fully_sharded=True)}")
    return dict(stats, device_ms=dev, collective_ms=coll, launches=launches,
                losses=result["losses"])


def unsupervised_sharded(root, main_launches, compact_launches) -> None:
    """``cora_unsup`` (150 steps) under ``UnsupervisedShardedTrainer``
    (compact) and ``UnsupervisedFullyShardedTrainer`` in the world of one,
    counters set to 0 just before and read just after: the loss drop and
    the probe's micro-F1 against the bars of ``PERF.md`` §2 (last-10 mean
    below first-10 minus 0.3; probe above chance + 0.2), host and device
    ms per step."""
    cfg = preset_config("cora_unsup")
    host = load_dataset("cora", root, "cpu")
    steps = cfg.train.num_steps
    groups = cfg.train.batch_size * (2 + cfg.train.num_negatives)
    for cls, kw in ((UnsupervisedShardedTrainer, dict(gather_mode="compact")),
                    (UnsupervisedFullyShardedTrainer, {})):
        label = cls.__name__
        reset_launches()
        tr = cls(build_model(cfg, host, "cuda"), host, cfg.train, make_mesh({"data": 1}), **kw)
        result = tr.run(log=None)
        launches = read_launches()
        full_probe = cls is UnsupervisedShardedTrainer
        want = compact_step_launches(tr.model, tr.features.rows_per_shard, groups, steps,
                                     0 if full_probe else 1)
        want["spmm_mean"] = tr.model.num_layers if full_probe else 0
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want {want}")
        for kernel, count in launches.items():
            main_launches[kernel] += count
        for kernel, count in mean_mode(launches).items():
            compact_launches[kernel] += count
        losses = np.asarray(result["losses"])
        drop = float(losses[:10].mean() - losses[-10:].mean())
        chance = 1.0 / host.num_classes
        held = dict(loss=drop > UNSUP_BARS["loss_drop"],
                    probe=result["val_micro_f1"] > chance + UNSUP_BARS["probe_margin"],
                    finite=bool(np.isfinite(losses).all()))
        host_ms = result["mean_step_time"] * 1e3
        dev, top = step_device_ms(tr)
        print(f"   {label} cora_unsup: loss first-10 {losses[:10].mean():.4f} -> last-10 "
              f"{losses[-10:].mean():.4f} (drop {drop:.4f}, bar {UNSUP_BARS['loss_drop']}); "
              f"probe val micro-F1 {result['val_micro_f1']:.4f} (bar above "
              f"{chance + UNSUP_BARS['probe_margin']:.4f}); held {held}; host ms per step "
              f"{host_ms:.3f}, device ms {dev:.4f}, idle share {1 - dev / host_ms:.3f}, top "
              f"{top}; launches {launches}")
        if not all(held.values()):
            raise AssertionError(f"{label}: bars missed: {held}")


def compact_buffer_kernels(models, graphs, timings, errs) -> None:
    """Kernels 1 and 2 (mean modes) at the compact answer-buffer shapes of
    a world of one: the preset batch's deepest hop routed by
    ``route_buckets`` into ``[cap, 128]`` (cap = 1.5x the requests), read at
    ``take``; each against its plain version (``TOL``) and kernel 1 against
    the direct gather-mean; timed as phase 5 times them."""
    for label in ("cora", "pubmed"):
        g = graphs[label]
        batch = PRESETS[PRESET_OF[label]].train.batch_size
        table, idx, mask = frontier_inputs(models[label], g, batch, seed=3)
        b, k = idx.shape
        shard = shard_features(table, 1, 0).shard
        cap = request_capacity(idx.numel(), 1, 1.5)
        req, take, violated = route_buckets(idx.reshape(-1), 1, shard.shape[0], cap,
                                            mask.reshape(-1))
        if bool(violated):
            raise AssertionError(f"compact buffer {label}: the route overflowed")
        # The owner's answers: its rows at the routed ids, row 0 for the
        # masked and unused slots (sent as -1).
        buffer = shard.index_select(0, req.reshape(-1).clamp(min=0).long()).contiguous()
        slots = take.to(torch.int32).view(b, k).contiguous()
        got = gm_kernel.gather_mean(buffer, slots, mask)
        e = max_err(got, gm_kernel.gather_mean_plain(buffer, slots, mask),
                    f"gather_mean compact buffer {label}")
        max_err(got, gm_kernel.gather_mean(table, idx, mask),
                f"gather_mean compact buffer {label} against the direct gather")
        check_repeat(got, lambda: gm_kernel.gather_mean(buffer, slots, mask),
                     f"gather_mean compact buffer {label}")
        errs["gather_mean_compact"] = max(errs["gather_mean_compact"], e)
        grad = torch.randn(b, table.shape[1], generator=torch.Generator().manual_seed(5)).to(
            g.device)
        rows = buffer.shape[0]
        es = max_err(sm_kernel.scatter_mean(grad, slots, mask, rows),
                     sm_kernel.scatter_mean_plain(grad, slots, mask, rows),
                     f"scatter_mean compact buffer {label}")
        errs["scatter_mean_compact"] = max(errs["scatter_mean_compact"], es)
        print(f"   compact buffer {label}: [{rows},{table.shape[1]}] f32, B={b}, k={k}: "
              f"gather max_abs_err={e:.3g}, scatter max_abs_err={es:.3g}")
        st = slot_stats(slots, mask)
        timings["gather_mean_compact"].append(gather_record(
            label, f"{label} compact answer buffer", buffer, slots, mask, st))
        timings["scatter_mean_compact"].append(scatter_record(
            label, f"{label} compact answer buffer, backward", buffer, slots, mask, st))
    print_records({k: timings[k] for k in COMPACT_KERNELS})


def compact_and_fully_sharded(graphs, roots, results, timings, errs, main_launches,
                              compact_launches) -> None:
    """This slice's phases in the world of one over NCCL (see the module
    docstring, phase 14)."""
    with phase("compact: answer-buffer kernels"):
        models = {label: GraphSAGE.from_config(
            PRESETS[PRESET_OF[label]].model, graphs[label].num_features,
            graphs[label].num_classes, generator=torch.Generator().manual_seed(0))
            for label in ("cora", "pubmed")}
        timings.update({k: [] for k in COMPACT_KERNELS})
        errs.update({k: 0.0 for k in COMPACT_KERNELS})
        compact_buffer_kernels(models, graphs, timings, errs)
    for name in ("cora", "pubmed"):
        with phase(f"compact: ShardedFeatureTrainer(gather_mode='compact'), {name}"):
            results[f"compact {name}"] = compact_run(name, roots[name],
                                                     results[f"sharded {name}"],
                                                     main_launches, compact_launches)
    with phase("compact: the retry ladder, cora"):
        ladder(roots["cora"], results["compact cora"])
    with phase("compact: the hub cache, pubmed_layer0_cached heavy-tailed"):
        hub_runs(graphs["pubmed heavy-tailed"], main_launches)
    for name in ("cora", "pubmed", "pubmed_layer0_cached"):
        with phase(f"fully sharded: {name}"):
            results[f"fully sharded {name}"] = fully_sharded_run(
                name, roots[PRESETS[name].dataset], main_launches, compact_launches)
    with phase("unsupervised: the sharded trainers, cora_unsup"):
        unsupervised_sharded(roots["cora"], main_launches, compact_launches)


TWO_RANK_STEPS = 20


def block_bytes(t: torch.Tensor) -> int:
    """The size of the caching allocator's live block that holds ``t``
    (measured: ``torch.cuda.memory_snapshot``; a block rounds its request
    up)."""
    ptr = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            if addr <= ptr < addr + blk["size"] and blk["state"] == "active_allocated":
                return int(blk["size"])
            addr += blk["size"]
    raise AssertionError(f"no live block holds the tensor at {ptr:#x}")


def fully_sharded_memory(tr, host) -> dict:
    """A fully sharded rank's device memory right after construction: the
    measured block of each graph array it holds (the feature shard and the
    adjacency shard's four arrays) beside the whole array's bytes, and the
    largest live block (before the first product allocates the cuBLAS
    workspace)."""
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    adj = tr.adjacency
    pairs = {"features": (tr.features.shard, host.features),
             "ell": (adj.ell, host.neighbors), "degrees": (adj.degrees, host.degrees),
             "indptr": (adj.indptr, host.indptr), "edge_dst": (adj.edge_dst, host.edge_dst)}
    torch.cuda.synchronize()
    live = memory.live_device_bytes(device=tr.device)
    return dict(blocks={k: block_bytes(mine) for k, (mine, _) in pairs.items()},
                whole={k: nbytes(whole) for k, (_, whole) in pairs.items()},
                largest=live["largest_buffer_bytes"], total=live["total_bytes"])


def two_rank_rank(rank: int, port: int, root: str, out: str) -> None:
    """One of two ranks sharing the card over gloo (NCCL refuses two ranks
    on one device), ``cora`` at S = 2 for ``TWO_RANK_STEPS`` steps each:
    first ``FullyShardedTrainer`` (the rank's measured device memory read
    right after it, before any run places a whole table), then the dense
    and the compact ``ShardedFeatureTrainer``; rank 0 also runs the
    single-device Trainer. Writes its losses, launch counts and memory to
    ``out`` as JSON."""
    os.environ["LOCAL_RANK"] = "0"  # both ranks on card 0
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=rank, world_size=2)
    multihost.initialize()
    if multihost.device() != torch.device("cuda", 0):
        raise AssertionError(f"rank {rank} bound {multihost.device()}, want cuda:0")
    cfg = preset_config("cora", {"num_steps": TWO_RANK_STEPS})
    host = load_dataset("cora", root, "cpu")
    mesh = make_mesh({"data": 2})
    rec = {}
    reset_launches()
    fully = FullyShardedTrainer(build_model(cfg, host, "cuda"), host, cfg.train, mesh)
    built = fully_sharded_memory(fully, host)
    res = fully.run(log=None)
    rec["fully"] = dict(losses=res["losses"], val=res["val_micro_f1"], launches=read_launches(),
                        mean_step_ms=res["mean_step_time"] * 1e3,
                        memory_stats=fully.memory_stats(), built=built)
    del fully, res
    for mode in ("dense", "compact"):
        reset_launches()
        tr = ShardedFeatureTrainer(build_model(cfg, host, "cuda"), host, cfg.train, mesh,
                                   gather_mode=mode)
        res = tr.run(log=None)
        rec[mode] = dict(losses=res["losses"], val=res["val_micro_f1"],
                         launches=read_launches(), shard_rows=int(tr.features.shard.shape[0]),
                         mean_step_ms=res["mean_step_time"] * 1e3)
    if rank == 0:
        g = host.to("cuda")
        rec["single_losses"] = Trainer(build_model(cfg, g), g, cfg.train).run(
            log=None)["losses"]
    with open(out, "w") as fh:
        json.dump(rec, fh)
    torch.distributed.destroy_process_group()


def two_ranks_on_one_card(root: str) -> None:
    """The 2-rank exchanges with CUDA tensors: two processes on the one card
    over gloo. The dense and compact runs held step for step against the
    single-device run; the fully sharded run must learn, and each rank's
    largest live block must be below the whole feature table's and the
    whole adjacency's bytes."""
    port = free_port()
    os.makedirs(os.path.join(REPO, "build", "chip_smoke"), exist_ok=True)
    outs = [os.path.join(REPO, "build", "chip_smoke", f"two_rank_{r}.json") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--two-rank",
                               str(r), str(port), root, outs[r]], cwd=REPO)
             for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0]:
        raise AssertionError(f"two ranks on one card: exit codes {rcs}")
    recs = []
    for out in outs:
        with open(out) as fh:
            recs.append(json.load(fh))
    want = recs[0]["single_losses"]
    steps = TWO_RANK_STEPS
    for r, rec in enumerate(recs):
        for mode in ("dense", "compact"):
            np.testing.assert_allclose(rec[mode]["losses"], want, rtol=RESUME_RTOL,
                                       err_msg=f"rank {r} {mode} != the single-device run")
        dense, compact = rec["dense"]["launches"], rec["compact"]["launches"]
        if not (dense["gather_mean_sum"] == steps + 1 and dense["scatter_mean_sum"] == steps):
            raise AssertionError(f"rank {r} dense: launches {dense}")
        if not (compact["gather_mean"] == steps + 1 and compact["gather_mean_sum"] == 0
                and compact["scatter_mean"] == 2 * steps
                and compact["scatter_mean_sum"] == steps):
            raise AssertionError(f"rank {r} compact: launches {compact}")
        fully = rec["fully"]
        losses = np.asarray(fully["losses"])
        if not (np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]):
            raise AssertionError(f"rank {r} fully sharded did not train: {losses}")
        built = fully["built"]
        whole_adj = sum(v for k, v in built["whole"].items() if k != "features")
        held_adj = sum(v for k, v in built["blocks"].items() if k != "features")
        if not (all(built["blocks"][k] < built["whole"][k] for k in built["whole"])
                and held_adj < whole_adj and built["largest"] < built["whole"]["features"]):
            raise AssertionError(f"rank {r} fully sharded holds a whole array: {built}")
    gap = {mode: float(np.max(np.abs(np.asarray(recs[0][mode]["losses"]) - want)
                              / np.abs(want))) for mode in ("dense", "compact")}
    fully = recs[0]["fully"]
    print(f"   two ranks on one card over gloo: cora at S = 2, {steps} steps; dense and "
          f"compact losses within {gap} (relative) of the single-device run's; rows per "
          f"rank {[r['dense']['shard_rows'] for r in recs]}; host ms per step dense "
          f"{[round(r['dense']['mean_step_ms'], 3) for r in recs]}, compact "
          f"{[round(r['compact']['mean_step_ms'], 3) for r in recs]}, fully sharded "
          f"{[round(r['fully']['mean_step_ms'], 3) for r in recs]}; val micro-F1 dense "
          f"{[r['dense']['val'] for r in recs]}, compact {[r['compact']['val'] for r in recs]}, "
          f"fully sharded {[r['fully']['val'] for r in recs]}; launches per rank dense "
          f"{recs[0]['dense']['launches']}, compact {recs[0]['compact']['launches']}, fully "
          f"sharded {fully['launches']}")
    print(f"   fully sharded at S = 2: loss {fully['losses'][0]:.4f} -> "
          f"{fully['losses'][-1]:.4f}; after construction, measured blocks per rank "
          f"{[r['fully']['built']['blocks'] for r in recs]} against the whole arrays' "
          f"{fully['built']['whole']} bytes, largest live block "
          f"{[r['fully']['built']['largest'] for r in recs]}, live total "
          f"{[r['fully']['built']['total'] for r in recs]}; after the run rank 0's "
          f"memory_stats {fully['memory_stats']}")


def time_edge_blocks(label, g, timings) -> None:
    """Kernel 3 unnormalised over one rank's edge block (the sharded SpMM's
    partial sums) at F=128: block 0 of S = 1 (the whole graph) and of S = 2,
    beside its plain version and ``torch.sparse.mm`` over the block's rows;
    the bound reads X once, the block's indptr and ids, and writes its
    rows."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (g.num_nodes, 128), dtype=np.float32)).to(g.device)
    n, f = x.shape
    for shards in (1, 2):
        blk = edge_block(partition_edges(g, shards), 0, g.device)
        rows, e = blk.indptr.numel() - 1, blk.edge_dst.numel()
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(blk.indptr.long(), blk.edge_dst.long(),
                                        torch.ones(e, device=g.device), size=(rows, n))
        kernel = lambda: spmm_kernel.spmm_block_sum(x, blk.indptr, blk.edge_dst)  # noqa: E731
        plain = lambda: spmm_kernel.spmm_mean_plain(x, blk.indptr, blk.edge_dst, False)  # noqa: E731
        lib = lambda: torch.sparse.mm(a, x)  # noqa: E731
        max_err(kernel(), plain(), f"spmm_block_sum {label} block 0 of {shards}",
                magnitude=spmm_kernel.spmm_mean_plain(x.abs(), blk.indptr, blk.edge_dst,
                                                      False))
        max_err(lib(), plain(), f"sparse.mm yardstick, {label} block 0 of {shards}",
                magnitude=spmm_kernel.spmm_mean_plain(x.abs(), blk.indptr, blk.edge_dst,
                                                      False))
        bd, by = bound(n * f * 4 + rows * f * 4 + (rows + 1) * 4 + e * 4, e * f)
        rec = dict(label=f"{label} edge block 0 of {shards}",
                   shape=f"{label} edge block 0 of {shards}: X [{n},{f}] f32, rows "
                         f"{blk.row0}..{blk.row0 + rows - 1}, E={e}, unnormalised",
                   ms=device_ms(kernel, "spmm_mean_kernel"), plain_ms=device_ms(plain),
                   library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
                   call_ms=call_ms(kernel))
        timings["spmm_mean"].append(rec)
        print_records({"spmm_mean": [rec]})


def cli_fully_sharded(root) -> None:
    """The CLI once: ``--mode fully-sharded --steps 20`` at ``cora`` in the
    world of one; it prints its memory line, the loss lines, ``Validation
    F1`` and ``Average batch time``, and ends the process group."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--preset", "cora", "--data-root", root, "--mode", "fully-sharded",
                    "--steps", "20"])
    lines = out.getvalue().splitlines()
    losses = [float(ln.split()[1]) for ln in lines[1:-2]]
    if not (lines[0].startswith("fully-sharded over 1 device(s): ")
            and lines[-2].startswith("Validation F1: ")
            and lines[-1].startswith("Average batch time: ") and np.isfinite(losses).all()):
        raise AssertionError(f"CLI --mode fully-sharded printed {lines}")
    print(f"   CLI --mode fully-sharded --steps 20, cora: {lines[0]}; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({len(losses)} lines); {lines[-2]}; {lines[-1]}")


def parallel(graphs, roots, results, timings, errs, main_launches, compact_launches) -> None:
    """The parallel phase: a world of one over NCCL on the card, then two
    ranks sharing it over gloo."""
    import torch.distributed as dist

    with phase("parallel: a world of one over NCCL"):
        info = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
        print(f"   {info}, backend {dist.get_backend()}, device {multihost.device()}")
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    for name in ("cora", "pubmed", "pubmed_layer0_cached"):
        with phase(f"parallel: ShardedFeatureTrainer, {name}"):
            results[f"sharded {name}"] = sharded_run(name, roots[PRESETS[name].dataset],
                                                     main_launches)
    with phase("parallel: distributed_full_graph_logits, pubmed heavy-tailed"):
        g = graphs["pubmed heavy-tailed"]
        mesh = make_mesh({"graph": 1})
        for preset in ("pubmed", "cora_pool"):
            model = GraphSAGE.from_config(PRESETS[preset].model, g.num_features,
                                          g.num_classes,
                                          generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                want = model.forward_full_graph(g)
                reset_launches()
                got = distributed_full_graph_logits(model, g, mesh)
                launches = read_launches()
            e = max_err(got, want, f"distributed_full_graph_logits {model.aggregator}")
            expect = model.num_layers if model.aggregator == "mean" else 0
            if launches["spmm_mean"] != expect:
                raise AssertionError(f"{model.aggregator}: launches {launches}")
            for kernel, count in launches.items():
                main_launches[kernel] += count
            print(f"   {model.aggregator}: logits {tuple(got.shape)} == forward_full_graph "
                  f"(max_abs_err {e:.3g}); launches {launches}")
        time_edge_blocks("pubmed heavy-tailed", g, timings)
    with phase("parallel: ShardedTrainer on {data: 1, model: 1}, pubmed"):
        cfg = preset_config("pubmed")
        g = load_dataset("pubmed", roots["pubmed"])
        reset_launches()
        tp = ShardedTrainer(build_model(cfg, g), g, cfg.train,
                            make_mesh({"data": 1, "model": 1}))
        it = tp.batches()
        got = [float(tp.step(next(it))) for _ in range(TP_STEPS)]
        launches = read_launches()
        for kernel, count in launches.items():
            main_launches[kernel] += count
        single = Trainer(build_model(cfg, g), g, cfg.train)
        it = single.batches()
        want = [float(single.step(next(it))) for _ in range(TP_STEPS)]
        np.testing.assert_allclose(got, want, rtol=RESUME_RTOL,
                                   err_msg="ShardedTrainer != Trainer")
        if (launches["gather_mean"], launches["scatter_mean"]) != (TP_STEPS, TP_STEPS):
            raise AssertionError(f"ShardedTrainer launches {launches}")
        print(f"   {TP_STEPS} steps {np.round(got, 6).tolist()} within {RESUME_RTOL} of the "
              f"Trainer's; launches {launches}")
    compact_and_fully_sharded(graphs, roots, results, timings, errs, main_launches,
                              compact_launches)
    with phase("parallel: the CLI, --mode fully-sharded"):
        cli_fully_sharded(roots["cora"])  # ends the process group
    if dist.is_initialized():
        raise AssertionError("the CLI left the process group formed")
    with phase("parallel: two ranks on one card over gloo, cora"):
        two_ranks_on_one_card(roots["cora"])


# ---------------------------------------------------------- the halo exchange
# Phase 15: full-graph training and serving through the halo exchange.
HALO_HUB = 100  # the stand-in's hub threshold: 0.3% of its rows (degrees up to 949)
HALO_TWO_RANK_STEPS = 20
HALO_RTOL = 1e-4
# A bf16 model's halo losses against one device's: its plan pads the rows to
# Np = round_up(N, 8), and cuBLAS's bf16 products over Np rows (the weight
# gradients contract over them) round in another order than over N.
HALO_BF16_RTOL = 1e-3
# Kernels 3 (forward over the combined CSR, backward over its transpose) and
# 2 (sum mode, the send gathers' transpose) on the halo path: their launches
# there are counted apart.
HALO_KERNELS = {"spmm_mean_halo": "spmm_mean", "scatter_mean_halo": "scatter_mean"}
# The two-rank phase's plans of the stand-in.
HALO_TWO_RANK_PLANS = {"auto": dict(order="auto"),
                       "bfs, per_offset, hub": dict(order="bfs", sizing="per_offset",
                                                    hub_threshold=HALO_HUB)}


def halo_stand_in(device=None):
    """The heavy-tailed Pubmed stand-in of phase 3."""
    return power_law_graph(19717, 44338, num_feats=500, num_classes=3, homophily=0.8,
                           device=device)


def native_partitioner(stand_in, reddit) -> None:
    """The native LPA and BFS: built from ``csrc/partitioner.cpp`` (the run
    fails when they are not), equal to numpy's on the stand-in and timed
    against them there (host ms), and timed alone at ``reddit``."""
    if native_partition.load_library() is None:
        raise AssertionError(f"the native partitioner did not build: "
                             f"{native_partition.build_error}")
    times = {}
    for name, native, plain in (
            ("lpa", lambda g: native_partition.lpa_assign_native(g, 2),
             lambda g: halo.lpa_assign(g, 2)),
            ("bfs", native_partition.bfs_order_native, halo.bfs_order)):
        t0 = time.perf_counter()
        got = native(stand_in)
        t1 = time.perf_counter()
        want = plain(stand_in)
        t2 = time.perf_counter()
        native(reddit)
        t3 = time.perf_counter()
        np.testing.assert_array_equal(got, want, err_msg=f"native {name} != numpy {name}")
        times[name] = dict(stand_in_native_ms=(t1 - t0) * 1e3, stand_in_numpy_ms=(t2 - t1) * 1e3,
                           reddit_native_ms=(t3 - t2) * 1e3)
    print(f"   native partitioner ({native_partition.library_path()}): equal to numpy on "
          f"the stand-in; host ms {json.dumps(times)}")


def halo_launches_per_step(model) -> tuple[int, int]:
    """Kernel 3's and kernel 2's (sum mode) launches in one halo step: kernel
    3 as on one device (``full_graph_step_launches``); kernel 2 once per
    exchange whose input needs a gradient (every maxpool layer; a mean
    layer's when its SpMM runs backward)."""
    k3 = full_graph_step_launches(model)["spmm_mean"]
    return k3, (k3 - model.num_layers if model.aggregator == "mean" else model.num_layers)


def halo_run(label, build, graph, train_cfg, plan, main_launches, halo_launches) -> dict:
    """``FullGraphTrainer(mesh=)`` in the world of one (``plan``: the
    partition's keywords; ``order="auto"`` is the trainer's default), the
    counters set to 0 just before and read just after, against the
    single-device ``FullGraphTrainer`` from the same seed, step for step
    (``HALO_RTOL``; ``HALO_BF16_RTOL`` for a bf16 model); host and device ms
    per step beside the single device's,
    the collectives' device ms, ``comm_stats``."""
    mesh = make_mesh({"graph": 1})
    t0 = time.perf_counter()
    native_partition.last_impl.clear()
    part = build_node_partition(graph, 1, **plan)
    t1 = time.perf_counter()
    if "numpy" in native_partition.last_impl.values():
        raise AssertionError(f"halo {label}: the numpy partitioner ran "
                             f"{native_partition.last_impl}")
    reset_launches()
    trainer = FullGraphTrainer(build(), graph, train_cfg, mesh, partition=part)
    plan_s, built_s = t1 - t0, time.perf_counter() - t1
    result = trainer.run(log=None)
    launches = read_launches()
    model, steps = trainer.model, train_cfg.num_steps
    k3, k2 = halo_launches_per_step(model)
    want = {name: 0 for name in KERNELS}
    want["spmm_mean"] = steps * k3 + (model.num_layers if model.aggregator == "mean" else 0)
    want["scatter_mean"] = want["scatter_mean_sum"] = steps * k2
    if launches != want:
        raise AssertionError(f"halo {label}: launches {launches}, want {want}")
    for kernel, count in launches.items():
        main_launches[kernel] += count
    for name, base in HALO_KERNELS.items():
        halo_launches[name] += launches[base]
    losses = np.asarray(result["losses"])
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"halo {label}: losses {losses}")
    single_trainer = FullGraphTrainer(build(), graph, train_cfg)
    single = single_trainer.run(log=None)
    rtol = HALO_RTOL if model.compute_dtype is None else HALO_BF16_RTOL
    np.testing.assert_allclose(losses, single["losses"], rtol=rtol,
                               err_msg=f"halo {label} != single-device {label}")
    by_name = device_profile(trainer.step, iters=10)
    single_by_name = device_profile(single_trainer.step, iters=10)
    dev_ms, single_ms = sum(by_name.values()), sum(single_by_name.values())
    host_ms = result["mean_step_time"] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # Where the halo step's extra device time goes: kernels by their gain.
    extra = {short_name(k): by_name.get(k, 0.0) - single_by_name.get(k, 0.0)
             for k in set(by_name) | set(single_by_name)}
    extra = sorted(extra.items(), key=lambda kv: -abs(kv[1]))[:6]
    print(f"   halo {label}: {steps} steps, plan {plan} built in {plan_s:.2f} s on the host "
          f"(partitioner {native_partition.last_impl or 'not needed'}), "
          f"the trainer (the rank's slice on the card) in {built_s:.2f} s, segments "
          f"{trainer.shard.segments}; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, within {relative_gap(losses, single['losses']):.3g} "
          f"(relative) of the single device's; val micro-F1 {result['val_micro_f1']:.4f} "
          f"(single {single['val_micro_f1']:.4f}); per step: host ms {host_ms:.3f} (single "
          f"{single['mean_step_time'] * 1e3:.3f}), device ms {dev_ms:.4f} (single "
          f"{single_ms:.4f}), idle share {1 - dev_ms / host_ms:.3f}, collectives "
          f"{collective_ms(by_name):.4f}; top {[(short_name(k), round(v, 5)) for k, v in top]}; "
          f"against the single device's, by kernel {[(k, round(v, 5)) for k, v in extra]}; "
          f"launches {launches}; comm_stats {trainer.partition.comm_stats()}")
    result["trainer"] = trainer
    return result


def halo_kernel_records(cases, timings, errs) -> None:
    """Kernel 3 on each case's combined CSR (the mean) and on its transpose
    (the backward's sum on ``g / deg`` in the table's dtype), and kernel 2's
    sum mode on its
    send list, against their plain versions (sums: each element held to the
    tolerance of its terms' magnitude) and timed beside them,
    ``torch.sparse.mm`` (kernel 3) or ``index_add_`` into zeros (kernel 2),
    and the bound: the buffer, ids and output once; one add per edge and
    element."""
    rng = torch.Generator().manual_seed(61)
    for label, sh, dtype in cases:
        dev = sh.indptr.device
        f, np_, width, e = 128, sh.nodes_per_shard, sh.width, int(sh.cols.numel())
        elt = torch.empty((), dtype=dtype).element_size()
        buf = torch.randn(width, f, generator=rng).to(device=dev, dtype=dtype)
        gs = torch.randn(np_, f, generator=rng).to(device=dev, dtype=dtype)
        g2 = torch.randn(sh.send_idx.shape[0], f, generator=rng).to(dev)
        deg = (sh.indptr[1:] - sh.indptr[:-1]).long()
        vals = (1.0 / deg.clamp(min=1).float()).repeat_interleave(deg)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            mean = torch.sparse_csr_tensor(sh.indptr.long(), sh.cols.long(), vals.to(dtype),
                                           size=(np_, width))
            ones = torch.sparse_csr_tensor(sh.t_indptr.long(), sh.t_cols.long(),
                                           torch.ones(e, device=dev, dtype=dtype),
                                           size=(width, np_))
        valid = sh.send_mask[:, 0]
        ids = sh.send_idx[:, 0][valid]
        n_valid = int(valid.sum())
        fwd = lambda: spmm_kernel.spmm_block_sum(buf, sh.indptr, sh.cols, normalize=True)  # noqa: E731
        fwd_plain = lambda: spmm_kernel.spmm_mean_plain(buf, sh.indptr, sh.cols, True)  # noqa: E731
        bwd = lambda: spmm_kernel.spmm_block_sum(gs, sh.t_indptr, sh.t_cols)  # noqa: E731
        bwd_plain = lambda: spmm_kernel.spmm_mean_plain(gs, sh.t_indptr, sh.t_cols, False)  # noqa: E731
        sc = lambda: sm_kernel.scatter_mean(g2, sh.send_idx, sh.send_mask, np_, False)  # noqa: E731
        sc_plain = lambda: sm_kernel.scatter_mean_plain(g2, sh.send_idx, sh.send_mask, np_, False)  # noqa: E731
        tol = TOL if dtype == torch.float32 else BF16_TOL
        errs["spmm_mean_halo"] = max(
            errs.get("spmm_mean_halo", 0.0),
            max_err(fwd(), fwd_plain(), f"kernel 3 on the halo buffer, {label}", tol,
                    magnitude=spmm_kernel.spmm_mean_plain(buf.abs(), sh.indptr, sh.cols,
                                                          True).float()),
            max_err(bwd(), bwd_plain(), f"kernel 3 on the transposed CSR, {label}", tol,
                    magnitude=spmm_kernel.spmm_mean_plain(gs.abs(), sh.t_indptr, sh.t_cols,
                                                          False).float()))
        errs["scatter_mean_halo"] = max(
            errs.get("scatter_mean_halo", 0.0),
            max_err(sc(), sc_plain(), f"kernel 2's sum mode on the send list, {label}",
                    magnitude=sm_kernel.scatter_mean_plain(g2.abs(), sh.send_idx, sh.send_mask,
                                                           np_, False)))
        rows = [
            ("spmm_mean_halo", label, f"{label} forward: buffer [{width},{f}] {dtype}, "
             f"{np_} rows, E={e}, segments {[seg.kind for seg in sh.segments]}", fwd, fwd_plain,
             lambda: library_ms(lambda: torch.sparse.mm(mean, buf),
                               lambda: torch.sparse.mm(mean.to(torch.float32), buf.float()),
                               f"sparse.mm {label} forward"),
             bound(width * f * elt + (np_ + 1) * 4 + e * 4 + np_ * f * elt, e * f + np_ * f)),
            ("spmm_mean_halo", f"{label} backward", f"{label} backward: g/deg [{np_},{f}] "
             f"{dtype} over the transpose into [{width},{f}]", bwd, bwd_plain,
             lambda: library_ms(lambda: torch.sparse.mm(ones, gs),
                                lambda: torch.sparse.mm(ones.to(torch.float32), gs.float()),
                                f"sparse.mm {label} backward"),
             bound(np_ * f * elt + (width + 1) * 4 + e * 4 + width * f * elt, e * f)),
            ("scatter_mean_halo", label, f"{label}: g [{g2.shape[0]},{f}] f32 into "
             f"[{np_},{f}], {n_valid} valid send slots", sc, sc_plain,
             lambda: (device_ms(lambda: torch.zeros(np_, f, device=dev).index_add_(
                0, ids, g2[valid])), "zeros, then index_add_"),
             bound(n_valid * f * 4 + g2.shape[0] * 5 + np_ * f * 4, n_valid * f)),
        ]
        for name, rec_label, shape, kernel, plain, lib, (bd, by) in rows:
            kname = "spmm_mean_kernel" if name == "spmm_mean_halo" else "scatter"
            lib_ms, lib_note = lib()
            rec = dict(label=rec_label, shape=shape, ms=device_ms(kernel, kname),
                       plain_ms=device_ms(plain), library_ms=lib_ms, library_note=lib_note,
                       bound_ms=bd, bound_by=by, call_ms=call_ms(kernel))
            timings.setdefault(name, []).append(rec)
            print_records({name: [rec]})
        del mean, ones, buf
        torch.cuda.empty_cache()


def halo_serving(name, graph, build, part, requests, main_launches, halo_launches) -> None:
    """``ServingEngine(mesh=)`` in the world of one (``part``: the training
    run's plan of the graph), the counters set to 0
    just before and read just after (kernel 3 once per mean layer in the
    refresh, kernel 1's sum mode once per request: the owner exchange),
    against the single-device table tier on the same requests; a warm
    refresh's and a request's host ms; ``memory_stats``."""
    model = build()
    single = ServingEngine(model, graph)
    reset_launches()
    sharded = ServingEngine(model, graph, mesh=make_mesh({"graph": 1}), partition=part)
    got = [sharded.logits(r) for r in requests]
    launches = read_launches()
    want = {k: 0 for k in KERNELS}
    want["spmm_mean"] = model.num_layers if model.aggregator == "mean" else 0
    want["gather_mean"] = want["gather_mean_sum"] = len(requests)
    if launches != want:
        raise AssertionError(f"sharded serving {name}: launches {launches}, want {want}")
    for kernel, count in launches.items():
        main_launches[kernel] += count
    halo_launches["spmm_mean_halo"] += launches["spmm_mean"]
    agree = []
    for r, logits in zip(requests, got):
        want_logits = single.logits(r)
        if model.compute_dtype is None:
            np.testing.assert_allclose(logits, want_logits, **TOL,
                                       err_msg=f"sharded serving {name}")
        else:  # bf16: sums in another order round to neighbouring values
            gap = np.abs(logits - want_logits).max() / np.abs(want_logits).max()
            if not gap <= 2e-2:
                raise AssertionError(f"sharded serving {name}: logits off by {gap:.3g}")
        agree.append(float((logits.argmax(-1) == want_logits.argmax(-1)).mean()))
    if min(agree) < (1.0 if model.compute_dtype is None else 0.99):
        raise AssertionError(f"sharded serving {name}: predictions agree on {agree}")
    _, refresh_ms = timed(sharded.refresh)
    _, request_ms = timed(lambda: sharded.logits(requests[0]))
    print(f"   sharded serving {name}: answers equal the single-device table tier's "
          f"(predictions agree on {min(agree):.4f}); launches {launches}; warm refresh "
          f"{refresh_ms:.3f} host ms, request of {len(requests[0])} {request_ms:.3f} host ms; "
          f"memory_stats {sharded.memory_stats()}")


def halo_two_rank_rank(rank: int, port: int, out: str) -> None:
    """One of two ranks sharing the card over gloo: each plan of
    ``HALO_TWO_RANK_PLANS`` over the stand-in, its halo logits against the
    single-device ``forward_full_graph`` and ``HALO_TWO_RANK_STEPS`` halo
    steps against the single-device trainer's, ``comm_stats`` beside
    ``partition_comm_rows``'s estimate. Writes JSON to ``out``."""
    os.environ["LOCAL_RANK"] = "0"  # both ranks on card 0
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=rank, world_size=2)
    multihost.initialize()
    host = halo_stand_in("cpu")
    g = host.to(multihost.device())
    cfg = preset_config("pubmed", {"learning_rate": 0.1, "num_steps": HALO_TWO_RANK_STEPS})
    mesh = make_mesh({"graph": 2})
    rec = {}
    for name, kw in HALO_TWO_RANK_PLANS.items():
        t0 = time.perf_counter()
        native_partition.last_impl.clear()
        part = build_node_partition(host, 2, **kw)
        plan_s = time.perf_counter() - t0
        model = build_model(cfg, g)
        with torch.no_grad():
            err = max_err(halo_full_graph_logits(model, part, mesh), model.forward_full_graph(g),
                          f"rank {rank} halo logits, {name}")
        reset_launches()
        tr = FullGraphTrainer(build_model(cfg, g), host, cfg.train, mesh, partition=part)
        res = tr.run(log=None)
        launches = read_launches()
        k3, k2 = halo_launches_per_step(tr.model)
        want = {"spmm_mean": HALO_TWO_RANK_STEPS * k3 + tr.model.num_layers,
                "scatter_mean_sum": HALO_TWO_RANK_STEPS * k2}
        single = FullGraphTrainer(build_model(cfg, g), g, cfg.train).run(log=None)
        chosen = kw
        if kw.get("order") == "auto":
            plan = auto_partition_plan(host, 2)
            chosen = {k: plan[k] for k in ("order", "sizing", "hub_threshold")}
        rec[name] = dict(logits_err=err, losses=res["losses"], single_losses=single["losses"],
                         launches=launches, want_launches=want,
                         host_ms=res["mean_step_time"] * 1e3,
                         single_host_ms=single["mean_step_time"] * 1e3, plan_s=plan_s,
                         chosen=chosen, comm_stats=part.comm_stats(),
                         estimate=partition_comm_rows(host, 2, **chosen),
                         segments=[list(seg) for seg in tr.shard.segments],
                         native=dict(native_partition.last_impl))
    with open(out, "w") as fh:
        json.dump(rec, fh)
    torch.distributed.destroy_process_group()


def halo_two_ranks() -> None:
    """The halo exchange with CUDA tensors between two processes on the one
    card over gloo (NCCL refuses two ranks on one device)."""
    port = free_port()
    os.makedirs(os.path.join(REPO, "build", "chip_smoke"), exist_ok=True)
    outs = [os.path.join(REPO, "build", "chip_smoke", f"halo_rank_{r}.json") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--halo-two-rank",
                               str(r), str(port), outs[r]], cwd=REPO) for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0]:
        raise AssertionError(f"halo, two ranks on one card: exit codes {rcs}")
    recs = []
    for out in outs:
        with open(out) as fh:
            recs.append(json.load(fh))
    steps = HALO_TWO_RANK_STEPS
    for name in HALO_TWO_RANK_PLANS:
        for r, rec in enumerate(recs):
            got = rec[name]
            np.testing.assert_allclose(got["losses"], got["single_losses"], rtol=HALO_RTOL,
                                       err_msg=f"rank {r} halo {name} != the single device")
            la = got["launches"]
            if any(la[k] != v for k, v in got["want_launches"].items()) or not all(
                    la[k] == 0 for k in la if k not in ("spmm_mean", "scatter_mean",
                                                        "scatter_mean_sum")):
                raise AssertionError(f"rank {r} halo {name}: launches {la}, want "
                                     f"{got['want_launches']}")
            if got["comm_stats"]["rows_exchanged_per_shard"] != \
                    got["estimate"]["rows_exchanged_per_shard"]:
                raise AssertionError(f"rank {r} halo {name}: comm_stats {got['comm_stats']} "
                                     f"against the estimate {got['estimate']}")
            if "numpy" in got["native"].values():
                raise AssertionError(f"rank {r} halo {name}: the numpy partitioner ran "
                                     f"{got['native']}")
        r0 = recs[0][name]
        print(f"   two ranks over gloo, stand-in, {name} (chosen {r0['chosen']}, plan built in "
              f"{r0['plan_s']:.2f} s, segments {r0['segments']}): logits within "
              f"{[rec[name]['logits_err'] for rec in recs]} of forward_full_graph; {steps} "
              f"losses {r0['losses'][0]:.4f} -> {r0['losses'][-1]:.4f} within "
              f"{max(relative_gap(rec[name]['losses'], rec[name]['single_losses']) for rec in recs):.3g} "
              f"(relative) of one device; host ms per step {[round(rec[name]['host_ms'], 3) for rec in recs]} "
              f"(one device {round(r0['single_host_ms'], 3)}); launches per rank "
              f"{r0['launches']}; comm_stats {r0['comm_stats']}; partition_comm_rows "
              f"{r0['estimate']}")


def halo_exchange(pg, graphs, roots, timings, errs, main_launches, halo_launches) -> None:
    """Phase 15 (see the module docstring)."""
    import torch.distributed as dist

    with phase("halo: a world of one over NCCL"):
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    with phase("halo: the native partitioner"):
        native_partitioner(graphs["pubmed heavy-tailed"], pg["reddit"])
    runs = {}
    pubmed = load_dataset("pubmed", roots["pubmed"])
    cora = load_dataset("cora", roots["cora"])
    for label, preset, graph, over, plan in (
            ("pubmed", "pubmed", pubmed, None, dict(order="auto")),
            ("pubmed heavy-tailed, hub", "pubmed", graphs["pubmed heavy-tailed"],
             {"learning_rate": 0.1, "num_steps": 100}, dict(hub_threshold=HALO_HUB)),
            ("reddit", "reddit", pg["reddit"], {"fanouts": (None, None)}, dict(order="input")),
            ("cora_pool", "cora_pool", cora, None, dict(order="auto"))):
        with phase(f"halo: FullGraphTrainer(mesh=), {label}"):
            cfg = preset_config(preset, over)
            runs[label] = halo_run(label, lambda cfg=cfg, graph=graph: build_model(cfg, graph),
                                   graph, cfg.train, plan, main_launches, halo_launches)
    with phase("halo: kernels 3 and 2 at the halo shapes"):
        dev = multihost.device()
        cases = [("pubmed", build_node_partition(pubmed, 2).local(0, dev), torch.float32),
                 ("pubmed heavy-tailed", build_node_partition(
                     graphs["pubmed heavy-tailed"], 2,
                     **HALO_TWO_RANK_PLANS["bfs, per_offset, hub"]).local(0, dev),
                  torch.float32),
                 ("reddit", runs["reddit"]["trainer"].shard, torch.bfloat16)]
        halo_kernel_records(cases, timings, errs)
    for name, graph, over in (("pubmed", pubmed, None),
                              ("reddit", pg["reddit"], {"fanouts": (None, None)})):
        with phase(f"halo: ServingEngine(mesh=), {name}"):
            cfg = preset_config(name, over)
            rng = np.random.default_rng(71)
            halo_serving(name, graph, lambda cfg=cfg, graph=graph: build_model(cfg, graph),
                         runs[name]["trainer"].partition,
                         [rng.integers(0, graph.num_nodes, size) for size in (256, 1000)],
                         main_launches, halo_launches)
    del runs
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    with phase("halo: two ranks on one card over gloo, pubmed heavy-tailed"):
        halo_two_ranks()


# ------------------------------------------------- the sharded trainers' modes
# Phase 16: layer0="full" over the node-sharded store, FullyShardedTrainer(
# layer0="full"), int8 node-sharded tables, ShardedTrainer for full, lstm and
# int8.
MODES_STEPS = 40
# f32 runs against one device's: the same kernels and sums but for the
# order of the atomic adds of kernel 2 and of index_add_ (the table gather's
# backward).
MODES_RTOL = 1e-5
# bf16 runs against one device's: one bf16 rounding step (BF16_TOL's).
MODES_BF16_RTOL = 2.0**-7
MODES_TWO_RANK_STEPS = 20
MODES_TWO_RANK_RTOL = 1e-6
# cora over the int8 table, two ranks: a rank projects its [Np, F] int8
# rows with another cuBLAS reduction order than one device's [N, F]
# product, so the projected rows differ in their last bit; a layer-0
# pre-activation that close to ReLU's kink takes the other side, and one
# unit's gradient is then on for one run only. The run's dense twin (f32
# features holding the int8 values) takes the same steps at
# MODES_TWO_RANK_RTOL.
MODES_INT8_TWO_RANK_RTOL = RESUME_RTOL
# Kernel 3 over the node-sharded layer-0 table's CSR (forward, and its
# transpose in the backward) and kernel 1's int8 route over the compact
# exchange's int8 answer buffer: their launches on those paths are counted
# apart.
MODES_KERNELS = {"spmm_mean_layer0_sharded": "spmm_mean",
                 "gather_mean_int8_compact": "gather_mean"}


def sparse_csr(indptr, cols, values, width):
    """``torch.sparse.mm``'s CSR matrix ``[R, width]`` of a kernel-3 CSR."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(indptr.long(), cols[:int(indptr[-1])].long(), values,
                                       size=(indptr.numel() - 1, width))


def layer0_sharded_records(pubmed, timings, errs) -> None:
    """Kernel 3 at the node-sharded layer-0 table's shapes: the synthetic
    Pubmed graph's rank CSR (``slices_csr`` of ``shard_edge_slices``) over a
    projected ``[S * Np, 128]`` buffer, the world of one's (S = 1) and rank 0's
    of two, forward (the mean) and its transpose on ``g / deg`` (the
    backward), each against its plain version (the transpose a sum: held to
    its terms' magnitude) and a second launch of itself (bitwise); timed
    beside ``torch.sparse.mm`` over the same CSR (values ``1 / deg``, or
    ones). Bounds: the buffer rows the edges read, the CSR, the output."""
    host = pubmed.to("cpu")
    dev = pubmed.device
    gen = torch.Generator().manual_seed(16)
    recs = []
    for shards in (1, 2):
        csr = fs.slices_csr(fs.shard_edge_slices(host, shards, 0), dev)
        np_, e = csr.indptr.numel() - 1, int(csr.indptr[-1])
        width = shards * np_
        buf = torch.randn(width, 128, generator=gen).to(dev)
        g = torch.randn(np_, 128, generator=gen).to(dev)
        gs = (g / csr.count.clamp(min=1.0)[:, None]).contiguous()
        label = "pubmed" if shards == 1 else "pubmed, rank 0 of 2"
        for what, x, ind, cols, norm, rows_out in (
                ("forward", buf, csr.indptr, csr.cols, True, np_),
                ("transpose", gs, csr.t_indptr, csr.t_cols, False, width)):
            kernel = functools.partial(spmm_kernel.spmm_block_sum, x, ind, cols, normalize=norm)
            plain = functools.partial(spmm_kernel.spmm_mean_plain, x, ind, cols, norm)
            deg = (ind[1:] - ind[:-1]).clamp(min=1).float()
            vals = (1.0 / deg).repeat_interleave((ind[1:] - ind[:-1]).long()) if norm else (
                torch.ones(e, device=dev))
            a = sparse_csr(ind, cols, vals, x.shape[0])
            lib = lambda a=a, x=x: torch.sparse.mm(a, x)  # noqa: E731
            got = kernel()
            mag = None if norm else spmm_kernel.spmm_mean_plain(x.abs(), ind, cols, False)
            err = max_err(got, plain(), f"spmm layer-0 sharded {label} {what}", magnitude=mag)
            max_err(lib(), plain(), f"sparse.mm yardstick {label} {what}", magnitude=mag)
            check_repeat(got, kernel, f"spmm layer-0 sharded {label} {what}")
            errs["spmm_mean_layer0_sharded"] = max(errs["spmm_mean_layer0_sharded"], err)
            read_rows = int(torch.unique(cols[:e]).numel())
            bd, by = bound(read_rows * 128 * 4 + ind.numel() * 4 + e * 4 + rows_out * 128 * 4,
                           e * 128 + (rows_out * 128 if norm else 0))
            recs.append(dict(
                label=label if what == "forward" else f"{label}, transpose",
                shape=f"{label} {what}: buffer [{x.shape[0]},128] f32, {rows_out} rows out, "
                      f"E={e}{'' if norm else ', g / deg, unnormalised'}",
                ms=device_ms(kernel, "spmm_mean_kernel"), plain_ms=device_ms(plain),
                library_ms=device_ms(lib), bound_ms=bd, bound_by=by, call_ms=call_ms(kernel)))
    timings["spmm_mean_layer0_sharded"] = recs
    print_records({"spmm_mean_layer0_sharded": recs})


def int8_compact_records(models, graphs, timings, errs) -> None:
    """Kernel 1's int8 route over the compact exchange's int8 answer buffer
    (a world of one: the deepest hop of the preset's batch routed into
    ``[cap, F]`` int8 rows and their ``[cap, 1]`` scales, cap = 1.5x the
    requests, read at ``take``) on the synthetic Pubmed graph's table
    quantized and on ``powerlaw_1m``'s int8 table; against its plain version
    and the direct int8 gather-mean (bitwise: the same rows in the same
    order), and a second launch of itself; timed beside one
    ``F.embedding_bag`` (sum, per-slot weights ``scale / count``) over the
    buffer's values as f32. Bounds: the valid slots' int8 rows and scales,
    the ids and mask, the output."""
    recs = []
    for label in ("pubmed", "powerlaw_1m"):
        g, model = graphs[label], models[label]
        batch = PRESETS[label].train.batch_size
        qt = tq.quantize_features(g.features) if label == "pubmed" else g.features
        gen = torch.Generator(device=g.device).manual_seed(17)
        seeds = torch.randint(0, g.num_nodes, (batch,), generator=gen, device=g.device,
                              dtype=torch.int32)
        fr = model.sample(gen, g, seeds)
        L = model.num_layers
        n_out = fr.ids[L - 1].numel()
        idx = fr.ids[L].reshape(n_out, -1).contiguous()
        mask = fr.masks[L].reshape(n_out, -1).contiguous()
        b, k = idx.shape
        shard = shard_features(qt, 1, 0).shard
        cap = request_capacity(idx.numel(), 1, 1.5)
        req, take, violated = route_buckets(idx.reshape(-1), 1, shard.shape[0], cap,
                                            mask.reshape(-1))
        if bool(violated):
            raise AssertionError(f"int8 compact buffer {label}: the route overflowed")
        rows = req.reshape(-1).clamp(min=0).long()
        q, sc = shard.q.index_select(0, rows).contiguous(), shard.scale.index_select(0, rows)
        slots = take.to(torch.int32).view(b, k).contiguous()
        kernel = lambda: gm_kernel.gather_mean_int8(q, sc, slots, mask)  # noqa: E731
        plain = lambda: gm_kernel.gather_mean_int8_plain(q, sc, slots, mask)  # noqa: E731
        got = kernel()
        err = max_err(got, plain(), f"gather_mean int8 compact buffer {label}")
        direct = gm_kernel.gather_mean_int8(qt.q, qt.scale, idx, mask)
        torch.cuda.synchronize()
        if not torch.equal(got, direct):
            raise AssertionError(f"int8 compact buffer {label} != the direct int8 gather-mean")
        check_repeat(got, kernel, f"gather_mean int8 compact buffer {label}")
        errs["gather_mean_int8_compact"] = max(errs["gather_mean_int8_compact"], err)
        st = slot_stats(slots, mask)
        cnt = mask.sum(1, keepdim=True).clamp(min=1).float()
        weights = (sc[slots.long()][..., 0] / cnt)[mask]
        qf = q.float()
        lib = lambda: F.embedding_bag(st["flat"], qf, st["offsets"], mode="sum",  # noqa: E731
                                      per_sample_weights=weights)
        max_err(lib(), plain(), f"embedding_bag yardstick, int8 compact buffer {label}")
        f = q.shape[1]
        bd, by = bound(st["valid"] * (f + 4) + b * k + st["valid"] * 4 + b * f * 4,
                       2 * st["valid"] * f + st["live"] * f)
        recs.append(dict(
            label=label,
            shape=f"{label} int8 compact answer buffer: q [{cap},{f}] int8 and scales "
                  f"[{cap},1], B={b}, k={k}, {st['valid']} valid slots",
            ms=device_ms(kernel, "gather_mean_kernel"), plain_ms=device_ms(plain),
            library_ms=device_ms(lib), bound_ms=bd, bound_by=by, call_ms=call_ms(kernel)))
    timings["gather_mean_int8_compact"] = recs
    print_records({"gather_mean_int8_compact": recs})


def counted_run(make, main_launches) -> tuple:
    """``make()``'s trainer run, counters set to 0 just before the trainer
    is built and read just after the run: ``(trainer, result, launches)``;
    ``result["trainer"]`` is the trainer."""
    reset_launches()
    tr = make()
    result = tr.run(log=None)
    result["trainer"] = tr
    launches = read_launches()
    for kernel, count in launches.items():
        main_launches[kernel] += count
    return tr, result, launches


def full_sharded_launches(trainer, steps: int) -> dict:
    """Launches of a node-sharded ``layer0="full"`` mean run (project-first
    layer 0), ``steps`` steps and one sampled evaluation: kernel 3 builds
    the table slice in every forward and runs its transpose in every
    backward; the dense exchange's owner side is kernel 1's sum mode forward
    and kernel 2's backward, the compact one's owner backward kernel 2's sum
    mode (its rows are an ``index_select``); a halo plan that sends rows
    adds kernel 2's sum mode in every backward (the send gathers'
    transpose)."""
    want = {name: 0 for name in KERNELS}
    want["spmm_mean"] = 2 * steps + 1
    sends = trainer._layer0_halo is not None and bool(trainer._layer0_halo.segments)
    want["scatter_mean"] = want["scatter_mean_sum"] = steps * (1 + sends)
    if trainer.gather_mode == "dense":
        want["gather_mean"] = want["gather_mean_sum"] = steps + 1
    return want


def sharded_layer0_runs(root, results, main_launches, modes_launches) -> None:
    """``pubmed_layer0_full`` through ``ShardedFeatureTrainer`` (all-gather
    with the dense and the compact gathers, halo with the dense ones) for
    ``MODES_STEPS`` steps, each held step for step to the single-device
    ``Trainer`` (``MODES_RTOL``) and over the learning bar; then
    ``FullyShardedTrainer`` at covering fanouts against
    ``ShardedFeatureTrainer`` for ``COVER_STEPS`` steps."""
    cfg = preset_config("pubmed_layer0_full", {"num_steps": MODES_STEPS})
    host = load_dataset("pubmed", root, "cpu")
    dev_graph = host.to("cuda")
    single = Trainer(build_model(cfg, dev_graph), dev_graph, cfg.train)
    want = single.run(log=None)
    want["trainer"] = single
    single_stats = check_learning("pubmed_layer0_full, one device", want)
    mesh = make_mesh({"data": 1})
    for mode, exchange in (("dense", "allgather"), ("compact", "allgather"), ("dense", "halo")):
        label = f"pubmed_layer0_full, {exchange}, {mode} gathers"
        tr, res, launches = counted_run(lambda: ShardedFeatureTrainer(
            build_model(cfg, host, "cuda"), host, cfg.train, mesh, gather_mode=mode,
            layer0_exchange=exchange), main_launches)
        expect = full_sharded_launches(tr, MODES_STEPS)
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, want {expect}")
        modes_launches["spmm_mean_layer0_sharded"] += launches["spmm_mean"]
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=MODES_RTOL,
                                   err_msg=f"{label} != the single device")
        stats = check_learning(label, res)
        results[f"modes {label}"] = dict(stats, losses=res["losses"])
        mem = {k: v for k, v in tr.memory_stats().items() if "layer0" in k or "feature" in k}
        print(f"   {label}: {MODES_STEPS} losses within "
              f"{relative_gap(res['losses'], want['losses']):.3g} (relative) of one device's; "
              f"host ms {stats['host_ms_per_step']:.3f} (one device "
              f"{single_stats['host_ms_per_step']:.3f}), device ms "
              f"{stats['device_ms_per_step']:.4f} (one device "
              f"{single_stats['device_ms_per_step']:.4f}); launches {launches}; memory_stats "
              f"{mem}")
    cover = int(host.neighbors.shape[1])
    cov = preset_config("pubmed_layer0_full", {"num_steps": COVER_STEPS,
                                               "fanouts": (cover, cover)})
    got = {}
    for cls in (FullyShardedTrainer, ShardedFeatureTrainer):
        tr, res, launches = counted_run(lambda: cls(build_model(cov, host, "cuda"), host,
                                                    cov.train, mesh), main_launches)
        modes_launches["spmm_mean_layer0_sharded"] += launches["spmm_mean"]
        got[cls.__name__] = (tr, res, launches)
    fully, res, launches = got["FullyShardedTrainer"]
    np.testing.assert_allclose(res["losses"], got["ShardedFeatureTrainer"][1]["losses"],
                               rtol=MODES_RTOL,
                               err_msg="fully sharded pubmed_layer0_full != node-sharded")
    if launches["spmm_mean"] != 2 * COVER_STEPS + 1:
        raise AssertionError(f"fully sharded pubmed_layer0_full: launches {launches}")
    dev_ms, top = step_device_ms(fully)
    print(f"   FullyShardedTrainer pubmed_layer0_full at covering fanout {cover}: "
          f"{COVER_STEPS} losses within "
          f"{relative_gap(res['losses'], got['ShardedFeatureTrainer'][1]['losses']):.3g} of "
          f"the node-sharded run's; host ms per step {res['mean_step_time'] * 1e3:.3f}, "
          f"device ms {dev_ms:.4f}, top {top}; launches {launches}; memory_stats "
          f"{ {k: v for k, v in fully.memory_stats().items() if not k.startswith('measured')} }")


def int8_sharded_runs(pg, results, main_launches, modes_launches) -> None:
    """``powerlaw_1m`` over the int8 table through ``ShardedFeatureTrainer``
    (dense; compact with ``hub_cache_rows=HUB_ROWS``) and
    ``powerlaw_1m_layer0_cached`` over an int8 cache (compact), the
    preset's 30 steps each, held to the single-device ``Trainer`` over the
    same int8 graph (``MODES_BF16_RTOL``; the first run's reference is the
    int8 table run of phase 10), each over its learning floor."""
    host = pg["powerlaw_1m int8"].to("cpu")
    mesh = make_mesh({"data": 1})
    over = {"quantize_features": True}
    for name, kw in (("powerlaw_1m", dict(gather_mode="dense")),
                     ("powerlaw_1m", dict(gather_mode="compact", hub_cache_rows=HUB_ROWS)),
                     ("powerlaw_1m_layer0_cached", dict(gather_mode="compact"))):
        cfg = preset_config(name, over)
        label = f"{name} int8, {kw}"
        tr, res, launches = counted_run(lambda: ShardedFeatureTrainer(
            build_model(cfg, host, "cuda"), host, cfg.train, mesh, **kw), main_launches)
        steps = cfg.train.num_steps
        if name == "powerlaw_1m":
            want = results["powerlaw_1m int8 table"]["losses"]
            expect = {k: 0 for k in KERNELS}
            expect["gather_mean"] = steps + 1
            if kw["gather_mode"] == "dense":
                expect["gather_mean_sum"] = steps + 1
            else:
                modes_launches["gather_mean_int8_compact"] += launches["gather_mean"]
        else:
            g = pg["powerlaw_1m int8"]
            want = Trainer(build_model(cfg, g), g, cfg.train).run(log=None)["losses"]
            expect = {**{k: 0 for k in KERNELS}, "spmm_mean": 1}
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, want {expect}")
        np.testing.assert_allclose(res["losses"], want, rtol=MODES_BF16_RTOL,
                                   err_msg=f"{label} != the single device")
        check_learning(label, res, FLOORS[name if name != "powerlaw_1m"
                                          else "powerlaw_1m int8 table"])
        mem = {k: v for k, v in tr.memory_stats().items()
               if "feature" in k or "hub" in k or "cache" in k}
        print(f"   {label}: {steps} losses within {relative_gap(res['losses'], want):.3g} "
              f"(relative) of one device's; launches {launches}; {mem}")


def tp_modes(roots, pg, main_launches) -> None:
    """``ShardedTrainer`` on ``{data: 1, model: 1}`` (the tensor-parallel
    layer 0's code over one rank) for ``pubmed_layer0_full``, ``cora_lstm``
    and ``powerlaw_1m`` over the int8 table, ``TP_STEPS`` steps each against
    the single-device ``Trainer``."""
    mesh = make_mesh({"data": 1, "model": 1})
    for name, graph, over, rtol in (
            ("pubmed_layer0_full", load_dataset("pubmed", roots["pubmed"]), None, MODES_RTOL),
            ("cora_lstm", load_dataset("cora", roots["cora"]), None, MODES_RTOL),
            ("powerlaw_1m", pg["powerlaw_1m int8"], {"quantize_features": True},
             MODES_BF16_RTOL)):
        cfg = preset_config(name, over)
        reset_launches()
        tp = ShardedTrainer(build_model(cfg, graph), graph, cfg.train, mesh)
        it = tp.batches()
        got = [float(tp.step(next(it))) for _ in range(TP_STEPS)]
        launches = read_launches()
        for kernel, count in launches.items():
            main_launches[kernel] += count
        single = Trainer(build_model(cfg, graph), graph, cfg.train)
        it = single.batches()
        want = [float(single.step(next(it))) for _ in range(TP_STEPS)]
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   err_msg=f"ShardedTrainer {name} != Trainer")
        expect = {k: TP_STEPS * v for k, v in step_launches(
            tp.model, graph.num_nodes, cfg.train.batch_size).items()}
        if launches != expect:
            raise AssertionError(f"ShardedTrainer {name}: launches {launches}, want {expect}")
        dev, top = step_device_ms(tp)
        print(f"   ShardedTrainer {{data: 1, model: 1}} {name}{' int8' if over else ''}: "
              f"{TP_STEPS} losses within {relative_gap(got, want):.3g} (relative) of the "
              f"Trainer's; device ms per step {dev:.4f}, top {top}; launches {launches}")


def modes_comm_stats(pubmed, pg) -> None:
    """``sharded_comm_stats`` at S = 8 (host arithmetic, JAX's numbers):
    ``pubmed_layer0_full`` with its halo plan (``bounds="equal_nodes"``),
    and ``reddit``'s raw rows (aggregating first) in bf16 against int8."""
    host = pubmed.to("cpu")
    cfg = preset_config("pubmed_layer0_full")
    model = build_model(cfg, host)
    part = build_node_partition(host, 8, bounds="equal_nodes")
    stats = sharded_comm_stats(model, cfg.train.batch_size, 8, num_nodes=host.num_nodes,
                               layer0_partition=part)
    print(f"   pubmed_layer0_full sharded_comm_stats at S = 8: {stats}")
    cfg = preset_config("reddit", {"project_first": False})
    model = build_model(cfg, pg["reddit"])
    for label, kw in (("bf16", dict(feature_dtype=torch.bfloat16)), ("int8", dict(quantized=True))):
        print(f"   reddit raw rows {label} sharded_comm_stats at S = 8: "
              f"{sharded_comm_stats(model, cfg.train.batch_size, 8, **kw)}")


def modes_two_rank_rank(rank: int, port: int, pubmed_root: str, cora_root: str,
                        out: str) -> None:
    """One of two ranks sharing the card over gloo: ``pubmed_layer0_full``
    node-sharded with the all-gather and the halo table builds, and ``cora``
    over the int8 table with the compact gathers, ``MODES_TWO_RANK_STEPS``
    steps each, and the int8 run's dense twin (f32 features holding the int8
    values); rank 0 also runs each on one device. Writes JSON to ``out``."""
    os.environ["LOCAL_RANK"] = "0"  # both ranks on card 0
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=rank, world_size=2)
    multihost.initialize()
    mesh = make_mesh({"data": 2})
    rec = {}
    pubmed = load_dataset("pubmed", pubmed_root, "cpu")
    cora = quantize_graph(load_dataset("cora", cora_root, "cpu"))
    twin = dataclasses.replace(cora, features=tq.dequantize(cora.features))
    for label, name, host, kw in (
            ("pubmed_layer0_full, allgather", "pubmed_layer0_full", pubmed, {}),
            ("pubmed_layer0_full, halo", "pubmed_layer0_full", pubmed,
             dict(layer0_exchange="halo")),
            ("cora int8, compact", "cora", cora, dict(gather_mode="compact")),
            ("cora int8's dense twin, compact", "cora", twin, dict(gather_mode="compact"))):
        cfg = preset_config(name, {"num_steps": MODES_TWO_RANK_STEPS})
        reset_launches()
        tr = ShardedFeatureTrainer(build_model(cfg, host, "cuda"), host, cfg.train, mesh, **kw)
        res = tr.run(log=None)
        r = dict(losses=res["losses"], launches=read_launches(),
                 host_ms=res["mean_step_time"] * 1e3)
        if rank == 0:
            g = host.to("cuda")
            r["single_losses"] = Trainer(build_model(cfg, g), g, cfg.train).run(
                log=None)["losses"]
        rec[label] = r
    with open(out, "w") as fh:
        json.dump(rec, fh)
    torch.distributed.destroy_process_group()


def modes_two_ranks(roots) -> None:
    """The new modes with CUDA tensors between two processes on the one
    card over gloo, each within ``MODES_TWO_RANK_RTOL`` of one device
    (``cora`` int8: ``MODES_INT8_TWO_RANK_RTOL``)."""
    port = free_port()
    os.makedirs(os.path.join(REPO, "build", "chip_smoke"), exist_ok=True)
    outs = [os.path.join(REPO, "build", "chip_smoke", f"modes_rank_{r}.json") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--modes-two-rank",
                               str(r), str(port), roots["pubmed"], roots["cora"], outs[r]],
                              cwd=REPO) for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0]:
        raise AssertionError(f"the new modes, two ranks on one card: exit codes {rcs}")
    recs = []
    for out in outs:
        with open(out) as fh:
            recs.append(json.load(fh))
    for label, r0 in recs[0].items():
        want = r0["single_losses"]
        rtol = MODES_INT8_TWO_RANK_RTOL if label == "cora int8, compact" else MODES_TWO_RANK_RTOL
        for r, rec in enumerate(recs):
            np.testing.assert_allclose(rec[label]["losses"], want, rtol=rtol,
                                       err_msg=f"rank {r} {label} != the single device")
            la = rec[label]["launches"]
            k = "gather_mean" if label.startswith("cora") else "spmm_mean"
            if la[k] == 0:
                raise AssertionError(f"rank {r} {label}: no {k} launch: {la}")
        print(f"   two ranks over gloo, {label}: {MODES_TWO_RANK_STEPS} losses "
              f"{want[0]:.4f} -> {want[-1]:.4f} within "
              f"{max(relative_gap(rec[label]['losses'], want) for rec in recs):.3g} "
              f"(relative) of one device; host ms per step "
              f"{[round(rec[label]['host_ms'], 3) for rec in recs]}; launches per rank "
              f"{[rec[label]['launches'] for rec in recs]}")


def sharded_modes(pg, graphs, roots, results, timings, errs, main_launches,
                  modes_launches) -> None:
    """Phase 16 (see the module docstring)."""
    import torch.distributed as dist

    errs.update({k: 0.0 for k in MODES_KERNELS})
    with phase("modes: kernel 3 at the node-sharded layer-0 table's shapes"):
        layer0_sharded_records(graphs["pubmed"], timings, errs)
    with phase("modes: kernel 1's int8 route over the compact answer buffer"):
        models = {label: build_model(preset_config(label), g)
                  for label, g in (("pubmed", graphs["pubmed"]),
                                   ("powerlaw_1m", pg["powerlaw_1m int8"]))}
        int8_compact_records(models, {"pubmed": graphs["pubmed"],
                                      "powerlaw_1m": pg["powerlaw_1m int8"]}, timings, errs)
    with phase("modes: a world of one over NCCL"):
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    with phase("modes: pubmed_layer0_full node-sharded and fully sharded"):
        sharded_layer0_runs(roots["pubmed"], results, main_launches, modes_launches)
    with phase("modes: powerlaw_1m over int8 tables, node-sharded"):
        int8_sharded_runs(pg, results, main_launches, modes_launches)
    with phase("modes: ShardedTrainer on {data: 1, model: 1}, full, lstm and int8"):
        tp_modes(roots, pg, main_launches)
    with phase("modes: sharded_comm_stats at S = 8"):
        modes_comm_stats(graphs["pubmed"], pg)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    with phase("modes: two ranks on one card over gloo"):
        modes_two_ranks(roots)


# ---------------------------------------------------------- ingestion
# Phase 17: native and lazy ingestion. The loader-store runs repeat earlier
# phases' eager runs (same presets, steps and seeds) in this process: the
# stores are bitwise the eager ones, so the losses differ only by kernel 2's
# atomic order.
INGEST_STEPS = 40
INGEST_RTOL = 1e-6
INGEST_INT8_STEPS = 20
INGEST_TWO_RANK_STEPS = 20
# A small edge block for the CPU cache build: about 22 blocks of the
# synthetic Pubmed's 88648 edges.
INGEST_EDGE_BLOCK = 4096
INGEST_EXAMPLE_STEPS = "10"


def host_ms(fn) -> tuple:
    """``(fn(), its host ms)``."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def native_loader(roots) -> None:
    """The native eager parses of the synthetic Cora and Pubmed files equal
    the Python engine's bitwise, ``build_csr_native`` equals
    ``sorted_unique_edges``; host ms of the five passes at Pubmed size."""
    from graphsage_torch.data import loaders

    parse = {"cora": (loaders.parse_cora, native.parse_cora_native),
             "pubmed": (loaders.parse_pubmed, native.parse_pubmed_native)}
    for name, (py_parse, nat_parse) in parse.items():
        py, py_ms = host_ms(lambda: py_parse(roots[name]))
        nat, nat_ms = host_ms(lambda: nat_parse(roots[name]))
        for field in ("features", "labels", "edges"):
            a, b = getattr(py, field), getattr(nat, field)
            if not (a.dtype == b.dtype and np.array_equal(a, b)):
                raise AssertionError(f"{name}: the native parse's {field} differ")
        if py.num_classes != nat.num_classes:
            raise AssertionError(f"{name}: num_classes {py.num_classes} != {nat.num_classes}")
        n = py.features.shape[0]
        (indptr, indices), csr_ms = host_ms(lambda: native.build_csr_native(n, py.edges))
        e, py_csr_ms = host_ms(lambda: sorted_unique_edges(n, py.edges))
        if not (np.array_equal(np.repeat(np.arange(n), np.diff(indptr)), e[:, 0])
                and np.array_equal(indices, e[:, 1])):
            raise AssertionError(f"{name}: build_csr_native != sorted_unique_edges")
        print(f"   {name}: native parse == Python parse bitwise ({py.features.shape}, "
              f"{len(py.edges)} edges); build_csr_native == sorted_unique_edges "
              f"({len(indices)} entries); host ms: Python parse {py_ms:.1f}, native "
              f"{nat_ms:.1f}; CSR native {csr_ms:.1f}, numpy {py_csr_ms:.1f}")
    full = py.features  # Pubmed's
    n = full.shape[0]
    (_, py_rows), _ = host_ms(lambda: load_pubmed_lazy(roots["pubmed"], engine="python"))
    (lazy, nat_rows), index_ms = host_ms(lambda: load_pubmed_lazy(roots["pubmed"],
                                                                  engine="native"))
    rows_py, rows_py_ms = host_ms(lambda: py_rows(0, n))
    rows_nat, rows_nat_ms = host_ms(lambda: nat_rows(0, n))
    if not (np.array_equal(rows_py, full) and np.array_equal(rows_nat, full)):
        raise AssertionError("pubmed: a row loader's rows differ from the eager parse's")
    if lazy.features.stride(0) != 0:
        raise AssertionError(f"the lazy graph's features have strides {lazy.features.stride()}")
    print(f"   pubmed host ms: Python eager parse {py_ms:.1f}, native eager parse "
          f"{nat_ms:.1f}, lazy index pass (with build_graph) {index_ms:.1f}, all {n} rows "
          f"through the Python row_loader {rows_py_ms:.1f}, through the native one "
          f"{rows_nat_ms:.1f} (both equal to the eager table bitwise)")


def loader_store(lazy, rows, quantize=False) -> tuple:
    """The world of one's store from ``rows`` on the card, its host ms and
    the allocator's peak across its build (above what was allocated
    before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    store, ms = host_ms(lambda: shard_features_from_loader(
        rows, lazy.num_nodes, lazy.num_features, 1, 0, quantize=quantize))
    torch.cuda.synchronize()
    return store, ms, torch.cuda.max_memory_allocated() - base


def ingest_run(label, make, eager, main_launches, ingest_launches, expect) -> dict:
    """``make()``'s run counted (:func:`counted_run`), its launches held to
    ``expect(trainer)``, its losses to ``eager``'s within ``INGEST_RTOL``
    step for step, the learning bar; prints host and device ms per step
    beside the eager run's."""
    tr, res, launches = counted_run(make, main_launches)
    want = expect(tr)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    for kernel, count in launches.items():
        ingest_launches[kernel] += count
    np.testing.assert_allclose(res["losses"], eager["losses"], rtol=INGEST_RTOL,
                               err_msg=f"{label} != the eager store's run")
    stats = check_learning(label, res)
    print(f"   {label}: {len(res['losses'])} losses within "
          f"{relative_gap(res['losses'], eager['losses']):.3g} (relative) of the eager "
          f"store's; per step host ms {stats['host_ms_per_step']:.3f} (eager "
          f"{eager['host_ms_per_step']:.3f}), device ms {stats['device_ms_per_step']:.4f} "
          f"(eager {eager['device_ms_per_step']:.4f}); launches {launches}")
    return dict(stats, losses=res["losses"], trainer=tr)


def lazy_sharded_runs(roots, results, main_launches, ingest_launches) -> dict:
    """Lazy ``cora`` and ``pubmed`` (native row loader) through
    ``ShardedFeatureTrainer(feature_store=)`` in the world of one, dense and
    compact, against phases 13 and 14's eager runs; ``FullyShardedTrainer(
    feature_store=)`` at ``cora`` against phase 14's; ``pubmed_layer0_full``
    from the lazy Pubmed (kernel 3 over the store's slice) against phase
    16's. Returns the lazy graphs and stores."""
    mesh = make_mesh({"data": 1})
    lazy = {}
    for name, load in (("cora", load_cora_lazy), ("pubmed", load_pubmed_lazy)):
        graph, rows = load(roots[name], engine="native")
        store, ms, peak = loader_store(graph, rows)
        lazy[name] = (graph, rows, store)
        print(f"   lazy {name}: {graph}, features stride {graph.features.stride()}; the "
              f"store's build {ms:.1f} host ms, max_memory_allocated across it {peak} "
              f"bytes; feature bytes per rank {store.memory_stats()['feature_bytes_per_chip']}")
        cfg = preset_config(name, {"num_steps": INGEST_STEPS})
        for mode in ("dense", "compact"):
            expect = (
                (lambda tr: sharded_step_launches(tr.model, INGEST_STEPS)) if mode == "dense"
                else (lambda tr: compact_step_launches(
                    tr.model, tr.features.rows_per_shard, cfg.train.batch_size,
                    INGEST_STEPS, 1)))
            ingest_run(f"lazy {name}, {mode}", lambda: ShardedFeatureTrainer(
                build_model(cfg, graph, "cuda"), graph, cfg.train, mesh, gather_mode=mode,
                feature_store=store), results[f"{'sharded' if mode == 'dense' else 'compact'} "
                                              f"{name}"],
                main_launches, ingest_launches, expect)
    graph, _, store = lazy["cora"]
    cfg = preset_config("cora", {"num_steps": FULLY_STEPS})
    ingest_run("lazy cora, FullyShardedTrainer", lambda: FullyShardedTrainer(
        build_model(cfg, graph, "cuda"), graph, cfg.train, mesh, feature_store=store),
        results["fully sharded cora"], main_launches, ingest_launches,
        lambda tr: compact_step_launches(tr.model, tr.features.rows_per_shard,
                                         cfg.train.batch_size, FULLY_STEPS, 1))
    graph, _, store = lazy["pubmed"]
    cfg = preset_config("pubmed_layer0_full", {"num_steps": MODES_STEPS})
    ingest_run("lazy pubmed_layer0_full, allgather, dense gathers",
               lambda: ShardedFeatureTrainer(build_model(cfg, graph, "cuda"), graph,
                                             cfg.train, mesh, feature_store=store),
               results["modes pubmed_layer0_full, allgather, dense gathers"], main_launches,
               ingest_launches, lambda tr: full_sharded_launches(tr, MODES_STEPS))
    return lazy


def lazy_int8(roots, lazy, main_launches, ingest_launches) -> None:
    """``quantize=True``: the loader store bitwise the eager
    ``quantize_graph`` store; ``cora`` (dense, aggregating first, so that
    the owner sums int8 rows: projected first, it would gather f32 rows of
    the projected table) on each for ``INGEST_INT8_STEPS`` steps, within
    ``INGEST_RTOL``, through kernel 1's int8 route."""
    graph, rows, _ = lazy["cora"]
    store, ms, peak = loader_store(graph, rows, quantize=True)
    qhost = quantize_graph(load_dataset("cora", roots["cora"], "cpu"))
    eager = shard_features(qhost.features, 1, 0, store.shard.device)
    if not (torch.equal(store.shard.q, eager.shard.q)
            and torch.equal(store.shard.scale, eager.shard.scale)):
        raise AssertionError("the int8 loader store != the eager quantize_graph store")
    mesh = make_mesh({"data": 1})
    cfg = preset_config("cora", {"num_steps": INGEST_INT8_STEPS, "project_first": False})
    _, eager_res, eager_launches = counted_run(lambda: ShardedFeatureTrainer(
        build_model(cfg, qhost, "cuda"), qhost, cfg.train, mesh), main_launches)
    eager_res.update(check_learning("eager cora int8", eager_res))
    run = ingest_run("lazy cora int8, dense", lambda: ShardedFeatureTrainer(
        build_model(cfg, graph, "cuda"), graph, cfg.train, mesh, feature_store=store),
        eager_res, main_launches, ingest_launches, lambda tr: eager_launches)
    check_bf16_instances(run["trainer"], "gather_mean_kernel<signed char")
    print(f"   int8 loader store == the eager quantize_graph store bitwise (q and scales); "
          f"its build {ms:.1f} host ms, max_memory_allocated across it {peak} bytes; "
          f"feature bytes per rank {store.memory_stats()['feature_bytes_per_chip']}")


def descriptor_guards(lazy) -> None:
    """A lazy graph refuses the card, ``Trainer`` and ``ServingEngine``,
    naming the loader store and ``feature_store=``."""
    graph = lazy["cora"][0]
    cfg = preset_config("cora")
    model = build_model(cfg, graph, "cuda")
    for what, fn in (("lazy_graph.to('cuda')", lambda: graph.to("cuda")),
                     ("Trainer(lazy_graph)", lambda: Trainer(model, graph, cfg.train)),
                     ("ServingEngine(lazy_graph)", lambda: ServingEngine(model, graph))):
        try:
            fn()
        except ValueError as e:
            text = str(e)
            if not ("LAZY descriptor" in text and "shard_features_from_loader" in text
                    and "feature_store=" in text):
                raise AssertionError(f"{what} raised another error: {text}") from e
            print(f"   {what} raises: {text[:96]}...")
        else:
            raise AssertionError(f"{what} did not raise")


def edge_blocks(indptr: np.ndarray, edge_block: int) -> int:
    """The number of node-range blocks of the blocked CPU cache build."""
    n, r0, blocks = len(indptr) - 1, 0, 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + edge_block, side="right")) - 1
        r0, blocks = max(min(r1, n), r0 + 1), blocks + 1
    return blocks


def cache_builds(roots, main_launches, ingest_launches, errs) -> None:
    """``pubmed_layer0_cached``'s cache built on the CPU in blocks of
    ``INGEST_EDGE_BLOCK`` edges against the card's kernel-3 build, within
    ``1e-6``; the CPU build's host ms and peak traced host allocation."""
    import tracemalloc

    self_loop = preset_config("pubmed_layer0_cached").model.self_loop
    host = load_dataset("pubmed", roots["pubmed"], "cpu")
    indptr = host.indptr.numpy().astype(np.int64)
    f = host.num_features
    tracemalloc.start()
    cpu, blocked_ms = host_ms(lambda: with_cached_layer0(host, self_loop=self_loop,
                                                         edge_block=INGEST_EDGE_BLOCK))
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    _, one_block_ms = host_ms(lambda: with_cached_layer0(host, self_loop=self_loop))
    dev = host.to("cuda")
    reset_launches()
    card = with_cached_layer0(dev, self_loop=self_loop)
    launches = read_launches()
    if launches["spmm_mean"] != 1:
        raise AssertionError(f"the card's cache build: launches {launches}")
    for kernel, count in launches.items():
        main_launches[kernel] += count
        ingest_launches[kernel] += count
    e = max_err(card.layer0_cache, cpu.layer0_cache.to(dev.device), "blocked CPU cache build",
                tol=dict(rtol=1e-6, atol=1e-6))
    errs["spmm_mean"] = max(errs["spmm_mean"], e)
    out_bytes = host.num_nodes * f * 4
    print(f"   pubmed_layer0_cached cache (self_loop={self_loop}): the CPU build in "
          f"{edge_blocks(indptr, INGEST_EDGE_BLOCK)} blocks of at most {INGEST_EDGE_BLOCK} "
          f"edges equals the card's kernel-3 build (max_abs_err {e:.3g}); CPU host ms "
          f"{blocked_ms:.1f} (one block: {one_block_ms:.1f}); peak traced host allocation "
          f"{peak} bytes, of it the [N, F] f32 result {out_bytes}: transient "
          f"{peak - out_bytes} bytes, against {host.num_edges * f * 4} for one row per edge")


def ingest_two_rank_rank(rank: int, port: int, root: str, out: str) -> None:
    """One of two ranks sharing the card over gloo: lazy ``cora`` (native
    rows), the store from a loader that records its calls,
    ``ShardedFeatureTrainer(feature_store=)`` for ``INGEST_TWO_RANK_STEPS``
    steps. Writes the calls, losses and launches to ``out`` as JSON."""
    os.environ["LOCAL_RANK"] = "0"  # both ranks on card 0
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=rank, world_size=2)
    multihost.initialize()
    graph, rows = load_cora_lazy(root, engine="native")
    calls = []

    def loader(lo, hi):
        calls.append((lo, hi))
        return rows(lo, hi)

    store = shard_features_from_loader(loader, graph.num_nodes, graph.num_features, 2, rank)
    cfg = preset_config("cora", {"num_steps": INGEST_TWO_RANK_STEPS})
    reset_launches()
    tr = ShardedFeatureTrainer(build_model(cfg, graph, "cuda"), graph, cfg.train,
                               make_mesh({"data": 2}), feature_store=store)
    res = tr.run(log=None)
    with open(out, "w") as fh:
        json.dump(dict(calls=calls, losses=res["losses"], launches=read_launches(),
                       host_ms=res["mean_step_time"] * 1e3,
                       feature_bytes=tr.memory_stats()["feature_bytes_per_chip"]), fh)
    torch.distributed.destroy_process_group()


def ingest_two_ranks(root, results) -> None:
    """Each rank's loader is asked for its own rows and nothing else; the
    losses within ``INGEST_RTOL`` of the single-device run (phase 13's, from
    the same seed)."""
    port = free_port()
    os.makedirs(os.path.join(REPO, "build", "chip_smoke"), exist_ok=True)
    outs = [os.path.join(REPO, "build", "chip_smoke", f"ingest_rank_{r}.json") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ingest-two-rank",
                               str(r), str(port), root, outs[r]], cwd=REPO) for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0]:
        raise AssertionError(f"ingestion, two ranks on one card: exit codes {rcs}")
    recs = []
    for out in outs:
        with open(out) as fh:
            recs.append(json.load(fh))
    want = results["sharded cora"]["single_losses"][:INGEST_TWO_RANK_STEPS]
    n = 2708
    np_ = fs._rows_per_shard(n, 2)
    for r, rec in enumerate(recs):
        if [tuple(c) for c in rec["calls"]] != [(r * np_, min((r + 1) * np_, n))]:
            raise AssertionError(f"rank {r}'s loader was asked for {rec['calls']}")
        np.testing.assert_allclose(rec["losses"], want, rtol=INGEST_RTOL,
                                   err_msg=f"rank {r} != the single-device run")
        if rec["launches"]["gather_mean_sum"] == 0:
            raise AssertionError(f"rank {r}: no owner-side launch: {rec['launches']}")
    print(f"   two ranks over gloo, lazy cora: loader calls per rank "
          f"{[r['calls'] for r in recs]} (rows per rank {np_}); {INGEST_TWO_RANK_STEPS} "
          f"losses {want[0]:.4f} -> {want[-1]:.4f} within "
          f"{max(relative_gap(r['losses'], want) for r in recs):.3g} (relative) of one "
          f"device; host ms per step {[round(r['host_ms'], 3) for r in recs]}; feature "
          f"bytes per rank {[r['feature_bytes'] for r in recs]}; launches per rank "
          f"{[r['launches'] for r in recs]}")


EXAMPLES = ("01_train_cora", "02_unsupervised", "03_distributed", "04_serving",
            "05_pod_ingestion", "06_inductive", "07_skew_and_samplers", "08_layer0_modes")


def run_examples(roots) -> None:
    """Each of the port's eight examples once on the card, in this process,
    with ``INGEST_EXAMPLE_STEPS`` steps (Cora from the synthetic files):
    its host seconds and its last line."""
    import importlib

    for name in EXAMPLES:
        module = importlib.import_module(f"graphsage_torch.examples.{name}")
        argv = ["--steps", INGEST_EXAMPLE_STEPS]
        if name in ("01_train_cora", "02_unsupervised", "04_serving", "05_pod_ingestion"):
            argv += ["--data-root", roots["cora"]]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, ms = host_ms(lambda: module.main(argv))
        lines = buf.getvalue().strip().splitlines()
        if not lines:
            raise AssertionError(f"example {name} printed nothing")
        print(f"   example {name} ({ms / 1e3:.1f} s): {lines[-1]}")


def ingestion(roots, results, errs, main_launches, loader_build_ms) -> None:
    """Phase 17 (see the module docstring)."""
    import torch.distributed as dist

    ingest_launches = {name: 0 for name in KERNELS}
    with phase("ingestion: the native loader"):
        print(f"   {native.library_path()} built in {loader_build_ms:.0f} ms (phase 2)")
        native_loader(roots)
    with phase("ingestion: a world of one over NCCL"):
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    with phase("ingestion: lazy cora and pubmed through feature_store="):
        lazy = lazy_sharded_runs(roots, results, main_launches, ingest_launches)
    with phase("ingestion: the int8 loader store"):
        lazy_int8(roots, lazy, main_launches, ingest_launches)
    with phase("ingestion: the descriptor guards"):
        descriptor_guards(lazy)
    with phase("ingestion: the layer-0 cache, blocked on the CPU and kernel 3"):
        cache_builds(roots, main_launches, ingest_launches, errs)
    with phase("ingestion: the port's examples on the card"):
        run_examples(roots)
    # The path's kernels and modes: kernel 1's sum mode (dense owner side)
    # and mean mode (compact answer buffer), kernel 2's sum mode (owner
    # backward) and mean mode (answer-buffer gradient), kernel 3 (the
    # layer0="full" slice, the card's cache build).
    modes = {**ingest_launches, **mean_mode(ingest_launches)}
    missing = [k for k in ("gather_mean_sum", "gather_mean_compact", "scatter_mean_sum",
                           "scatter_mean_compact", "spmm_mean") if not modes[k]]
    if missing:
        raise AssertionError(f"ingestion: no launch of {missing}: {modes}")
    print(f"   ingestion path launches: {ingest_launches}, mean modes "
          f"{mean_mode(ingest_launches)}")
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    with phase("ingestion: two ranks on one card over gloo"):
        ingest_two_ranks(roots["cora"], results)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
        kind = torch.cuda.get_device_name(0)
        print(f"   torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with phase("build"):
        _build.library()
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("   " + line.strip())
        lib, loader_build_ms = host_ms(native.load_library)
        if lib is None:
            raise AssertionError(f"the native loader did not build: {native.build_error}")
        print(f"   native loader (csrc/graph_loader.cpp, g++): {loader_build_ms:.0f} ms")
    with phase("data"):
        data = os.path.join(REPO, "build", "chip_smoke")
        roots = {"cora": synth_cora_files(os.path.join(data, "cora")),
                 "pubmed": synth_pubmed_files(os.path.join(data, "pubmed"))}
        graphs = {"cora": load_cora(roots["cora"]), "pubmed": synthetic_pubmed_graph(),
                  "pubmed heavy-tailed": power_law_graph(
                      19717, 44338, num_feats=500, num_classes=3, homophily=0.8)}
        for label, g in graphs.items():
            deg = g.degrees
            print(f"   {label}: {g}; degree mean {float(deg.float().mean()):.3f}, "
                  f"max {int(deg.max())}, {int((deg > 25).sum())} nodes above 25")
    with phase("kernel checks"):
        errs = check_kernels(graphs)
    with phase("timings"):
        models = {
            label: GraphSAGE.from_config(
                PRESETS[PRESET_OF[label]].model, g.num_features, g.num_classes,
                generator=torch.Generator().manual_seed(0))
            for label, g in graphs.items()
        }
        timings = time_kernels(models, graphs)
    main_launches = {name: 0 for name in KERNELS}
    with phase("serving cora"):
        rng = np.random.default_rng(0)
        n = graphs["cora"].num_nodes
        serve_preset("cora", graphs["cora"],
                     [rng.integers(0, n, size) for size in (100, 256, 1000)],
                     main_launches)
    with phase("serving pubmed"):
        n = graphs["pubmed"].num_nodes
        serve_preset("pubmed", graphs["pubmed"], [rng.integers(0, n, 1024)],
                     main_launches)
    label = "pubmed heavy-tailed"
    with phase(f"serving {label}"):
        n = graphs[label].num_nodes
        serve_preset("pubmed", graphs[label], [rng.integers(0, n, 1024)],
                     main_launches, label=label,
                     cover_requests=[rng.integers(0, n, 8)])
    results = {}
    for name in ("cora", "pubmed"):
        with phase(f"training {name}"):
            results[name] = train_preset(name, roots[name], main_launches)
            results[name].update(check_learning(name, results[name]))
    with phase("training cora, gather_impl='dma'"):
        dma = train_preset("cora", roots["cora"], main_launches,
                           overrides={"gather_impl": "dma", "num_steps": 20})
        want = results["cora"]["losses"][:20]
        np.testing.assert_allclose(dma["losses"], want, rtol=LOSS_RTOL,
                                   err_msg="dma losses != default-route losses")
        diff = np.max(np.abs(np.asarray(dma["losses"]) - want) / np.abs(want))
        print(f"   dma route: 20 losses match the default route's (largest "
              f"relative difference {diff:.3g})")
    with phase(f"training {label}"):
        results[label] = train_preset("pubmed", None, main_launches,
                                      overrides=OVERRIDES_OF[label], graph=graphs[label])
        results[label].update(check_learning(label, results[label]))
    trainers = {name: r["trainer"] for name, r in results.items()}
    with phase("gradients, card against CPU"):
        check_gradients(trainers)
    with phase("project-first step times"):
        project_first_times(trainers)

    with phase("layer-0 cache"):
        errs["spmm_mean"] = max(errs["spmm_mean"], check_cache(graphs))
        print(f"   cache build on synthetic pubmed: "
              f"{cache_build_ms(trainers['pubmed'].graph)}")
    for name, root in (("pubmed_layer0_full", roots["pubmed"]),
                       ("pubmed_layer0_cached", roots["pubmed"]),
                       ("cora_pool", roots["cora"]), ("cora_lstm", roots["cora"])):
        with phase(f"training {name}"):
            results[name] = train_preset(name, root, main_launches)
            results[name].update(check_learning(name, results[name]))
    label = "pubmed_layer0_full heavy-tailed"
    with phase(f"training {label}"):
        results[label] = train_preset("pubmed_layer0_full", None, main_launches,
                                      overrides=OVERRIDES_OF[label],
                                      graph=graphs["pubmed heavy-tailed"])
        results[label].update(check_learning(label, results[label]))
    with phase("gradients of the new modes, card against CPU"):
        check_gradients({name: results[name]["trainer"]
                         for name in ("pubmed_layer0_full", "pubmed_layer0_full heavy-tailed",
                                      "cora_pool", "cora_lstm")})
    with phase("serving pubmed_layer0_full and cora_pool"):
        n = graphs["pubmed"].num_nodes
        serve_preset("pubmed_layer0_full", graphs["pubmed"],
                     [rng.integers(0, n, 1024)], main_launches)
        n = graphs["cora"].num_nodes
        serve_preset("cora_pool", graphs["cora"],
                     [rng.integers(0, n, size) for size in (100, 256, 1000)],
                     main_launches)
    with phase("pubmed layer-0 modes"):
        for label, graph, over in (
                ("synthetic pubmed", trainers["pubmed"].graph, None),
                ("pubmed heavy-tailed", graphs["pubmed heavy-tailed"],
                 OVERRIDES_OF["pubmed heavy-tailed"])):
            times = layer0_mode_times(graph, over)
            print(f"   layer-0 modes on {label}: " + json.dumps(times))
    with phase("layer-0 table gather backward"):
        gather_backward_times(graphs)

    with phase("data: the reduced-precision presets' graphs"):
        pg = {name: load_dataset(name) for name in ("reddit", "powerlaw", "powerlaw_1m")}
        pg["powerlaw_1m int8"] = quantize_graph(pg["powerlaw_1m"])
        pg["check"] = power_law_graph(30000, 250000, num_feats=602, num_classes=41,
                                      homophily=0.8, feature_dtype=torch.bfloat16)
        pg["models"] = {name: build_model(preset_config(name), pg[name])
                        for name in ("reddit", "powerlaw", "powerlaw_1m")}
        for label in ("reddit", "powerlaw", "powerlaw_1m", "powerlaw_1m int8"):
            g = pg[label]
            print(f"   {label}: {g}, features {g.features.dtype}, {g.nbytes} bytes on "
                  f"the card; degree max {int(g.degrees.max())}")
    with phase("kernel checks, reduced precision"):
        for name, e in check_precision_kernels(pg).items():
            errs[name] = max(errs[name], e)
    with phase("timings, reduced precision"):
        for name, recs in time_precision_kernels(pg).items():
            timings[name] += recs
    for name, graph, over, instance in (
            ("reddit", pg["reddit"], None, "gather_mean_kernel<__nv_bfloat16"),
            ("powerlaw", None, None, "gather_mean_kernel<float"),
            ("powerlaw_1m", pg["powerlaw_1m"], None, "gather_mean_kernel<__nv_bfloat16"),
            ("powerlaw_1m_layer0_cached", pg["powerlaw_1m"], None, None),
            ("powerlaw_1m int8 table", pg["powerlaw_1m int8"],
             {"quantize_features": True}, "gather_mean_kernel<signed char")):
        with phase(f"training {name}"):
            preset = name.split()[0]
            results[name] = train_preset(preset, None, main_launches, overrides=over,
                                         graph=graph)
            results[name].update(check_learning(name, results[name], FLOORS[name]))
            if instance:
                check_bf16_instances(results[name]["trainer"], instance)
            if name == "powerlaw_1m_layer0_cached":
                print(f"   cache build on powerlaw_1m (bf16, kernel 3): "
                      f"{cache_build_ms(pg['powerlaw_1m'])}")
    with phase("training reddit, gather_impl='dma'"):
        dma = train_preset("reddit", None, main_launches,
                           overrides={"gather_impl": "dma", "num_steps": 20},
                           graph=pg["reddit"])
        want = results["reddit"]["losses"][:20]
        np.testing.assert_allclose(dma["losses"], want, rtol=LOSS_RTOL,
                                   err_msg="reddit dma losses != default-route losses")
        check_bf16_instances(dma["trainer"], "gather_mean_dma_kernel<__nv_bfloat16")
        print(f"   dma route, bf16 rows: 20 losses match the default route's "
              f"(largest relative difference "
              f"{np.max(np.abs(np.asarray(dma['losses']) - want) / np.abs(want)):.3g})")
    with phase("gradients of bf16 models, card against CPU"):
        precision_gradients()
    with phase("serving reddit, and powerlaw with an int8 table"):
        serve_precision(pg, main_launches)
    with phase("reddit layer-0 orders"):
        project_first_times({"reddit": results["reddit"]["trainer"]},
                            batch_scales=(1, 2, 4, 8, 16))
    samplers_full_batch_multilabel(pg, graphs["pubmed"], roots["pubmed"], results,
                                   timings, main_launches)
    with phase("the segment max at the reddit-pool cell's shape"):
        recs, e = time_pool_cell_segment_max()
        timings["segment_max"] += recs
        errs["segment_max"] = max(errs["segment_max"], e)
    unsupervised_checkpoint_inductive(graphs, roots, results, timings, main_launches)
    compact_launches = {name: 0 for name in COMPACT_KERNELS}
    parallel(graphs, roots, results, timings, errs, main_launches, compact_launches)
    halo_launches = {name: 0 for name in HALO_KERNELS}
    halo_exchange(pg, graphs, roots, timings, errs, main_launches, halo_launches)
    modes_launches = {name: 0 for name in MODES_KERNELS}
    sharded_modes(pg, graphs, roots, results, timings, errs, main_launches, modes_launches)
    ingestion(roots, results, errs, main_launches, loader_build_ms)

    kernels = []
    entries = [(name, meta, main_launches[name]) for name, meta in KERNELS.items()]
    entries += [(name, KERNELS[base], compact_launches[name])
                for name, base in COMPACT_KERNELS.items()]
    entries += [(name, KERNELS[base], halo_launches[name])
                for name, base in HALO_KERNELS.items()]
    entries += [(name, KERNELS[base], modes_launches[name])
                for name, base in MODES_KERNELS.items()]
    for name, meta, launches in entries:
        recs = timings[name]
        head = next(r for r in recs if r["label"] == meta.get("head", "pubmed"))
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches,
            max_abs_err=errs[name], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shapes=recs,
        ))
        if launches == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--two-rank"]:  # a rank of the two-rank phase
        two_rank_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--halo-two-rank"]:  # a rank of the halo's two-rank phase
        halo_two_rank_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--modes-two-rank"]:  # a rank of phase 16's two-rank part
        modes_two_rank_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
        sys.exit(0)
    if sys.argv[1:2] == ["--ingest-two-rank"]:  # a rank of phase 17's two-rank part
        ingest_two_rank_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    try:
        sys.exit(main())
    except Exception:  # a failed phase: report it and exit without an ok line
        traceback.print_exc()
        sys.exit(1)
