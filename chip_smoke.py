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
   reads them when it aggregates first), beside the plain version, one
   PyTorch library call computing the same function (the scatter's:
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
8. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
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
import graphsage_torch.ops.spmm as spmm_kernel
from graphsage_torch import PRESETS, GraphSAGE, ServingEngine, load_cora, run_preset
from graphsage_torch.data.synthetic import (
    power_law_graph,
    synth_cora_files,
    synth_pubmed_files,
    synthetic_pubmed_graph,
)
from graphsage_torch.ops import _build
from graphsage_torch.train.experiments import build_model, preset_config
from graphsage_torch.train.trainer import Trainer

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
PRESET_OF = {"cora": "cora", "pubmed": "pubmed", "pubmed heavy-tailed": "pubmed"}
OVERRIDES_OF = {"pubmed heavy-tailed": {"learning_rate": 0.1}}
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
}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"   {name} done in {time.perf_counter() - t0:.1f} s", flush=True)


def reset_launches() -> None:
    for k in KERNELS.values():
        k["module"].launches = 0


def read_launches() -> dict:
    return {name: k["module"].launches for name, k in KERNELS.items()}


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


def device_ms(fn, kernel: str | None = None) -> float:
    """Summed device time per call of every kernel ``fn`` launches; with
    ``kernel``, also check that a kernel of that name ran."""
    by_name = device_profile(fn)
    if kernel is not None and not any(kernel in name for name in by_name):
        raise AssertionError(f"no {kernel} among the kernels run: {list(by_name)}")
    return sum(by_name.values())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        b, k = idx.shape
        n, f = table.shape
        valid = int(mask.sum())
        live = int(mask.any(1).sum())  # rows with a valid slot
        flat = idx[mask].long()
        offsets = torch.cat([mask.new_zeros(1, dtype=torch.long),
                             mask.sum(1).cumsum(0)[:-1]])
        lib = lambda: F.embedding_bag(flat, table, offsets, mode="mean")  # noqa: E731
        max_err(lib(), gm_kernel.gather_mean_plain(table, idx, mask),
                f"embedding_bag yardstick {label}")
        distinct = torch.unique(flat).numel()
        bd, by = bound(distinct * f * 4 + b * k + valid * 4 + b * f * 4,
                       valid * f + live * f)
        kernel = lambda: gm_kernel.gather_mean(table, idx, mask)  # noqa: E731
        out["gather_mean"].append(dict(
            label=label,
            shape=f"{label} sampled layer 0: table [{n},{f}] f32, B={b}, k={k}, "
                  f"{valid} valid slots, {live} rows with one, "
                  f"{distinct} distinct rows",
            ms=device_ms(kernel, "gather_mean_kernel"),
            plain_ms=device_ms(lambda: gm_kernel.gather_mean_plain(table, idx, mask)),
            library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
            call_ms=call_ms(kernel),
        ))
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
        fr = raw.shape[1]
        lib = lambda: F.embedding_bag(flat, raw, offsets, mode="mean")  # noqa: E731
        bd, by = bound(distinct * fr * 4 + b * k + valid * 4 + b * fr * 4,
                       valid * fr + live * fr)
        kernel = lambda: gm_kernel.gather_mean(raw, idx, mask)  # noqa: E731
        max_err(kernel(), gm_kernel.gather_mean_plain(raw, idx, mask),
                f"gather_mean mean-first {label}")
        out["gather_mean"].append(dict(
            label=f"{label} mean-first",
            shape=f"{label} sampled layer 0, mean-first: features [{n},{fr}] f32, "
                  f"B={b}, k={k}, {valid} valid slots",
            ms=device_ms(kernel, "gather_mean_kernel"),
            plain_ms=device_ms(lambda: gm_kernel.gather_mean_plain(raw, idx, mask)),
            library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
            call_ms=call_ms(kernel),
        ))
        kernel = lambda: dma_kernel.gather_mean_dma(raw, idx, mask)  # noqa: E731
        max_err(kernel(), gm_kernel.gather_mean_plain(raw, idx, mask),
                f"gather_mean_dma mean-first {label}")
        out["gather_mean_dma"].append(dict(
            out["gather_mean"][-1],
            ms=device_ms(kernel, "gather_mean_dma_kernel"),
            plain_ms=device_ms(lambda: dma_kernel.gather_mean_dma_plain(raw, idx, mask)),
            call_ms=call_ms(kernel),
        ))

        # The scatter (layer 0's backward) on the same frontier: the
        # cotangent [B, F] into [N, F], zeros included. Library: torch.zeros
        # and index_add_ of the precomputed per-slot rows g[b] / cnt[b] over
        # the valid ids alone (the division is left out of its time).
        grad = torch.randn(b, f, generator=torch.Generator().manual_seed(4)).to(table.device)
        cnt = mask.sum(1, keepdim=True).clamp(min=1).float()
        rows = (grad / cnt).repeat_interleave(k, dim=0)[mask.reshape(-1)]
        lib = lambda: torch.zeros(n, f, device=table.device).index_add_(0, flat, rows)  # noqa: E731
        max_err(lib(), sm_kernel.scatter_mean_plain(grad, idx, mask, n),
                f"zeros + index_add_ yardstick {label}")
        bd, by = bound(live * f * 4 + b * k + valid * 4 + n * f * 4,
                       valid * f + live * f)
        kernel = lambda: sm_kernel.scatter_mean(grad, idx, mask, n)  # noqa: E731
        # Device ms by kernel name: the zero fill against the scatter.
        split = device_profile(kernel)
        if not any("scatter_mean" in name for name in split):
            raise AssertionError(f"no scatter_mean among the kernels run: {list(split)}")
        split = {name.split("::")[-1].split("(")[0]: ms for name, ms in split.items()}
        print(f"   scatter_mean {label}: device ms by kernel {split}")
        out["scatter_mean"].append(dict(
            label=label,
            shape=f"{label} training layer-0 backward: g [{b},{f}] f32 into "
                  f"[{n},{f}], k={k}, {valid} valid slots, {live} rows with one",
            ms=sum(split.values()),
            plain_ms=device_ms(lambda: sm_kernel.scatter_mean_plain(grad, idx, mask, n)),
            library_ms=device_ms(lib), bound_ms=bd, bound_by=by,
            call_ms=call_ms(kernel), split=split,
        ))

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
            call_ms=call_ms(kernel),
        ))
    for name, recs in out.items():
        for r in recs:
            print(f"   {name} [{r['shape']}]: device ms: kernel {r['ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']}); per call "
                  f"through the wrapper {r['call_ms']:.4f} ms")
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
                 top_kernels=[(name.split("(")[0][-48:], ms) for name, ms in top],
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 **eng.memory_stats())
    if mode == "table":  # a warm refresh: host ms (mean of 5) and device ms
        stats["refresh_ms"] = timed(lambda: [eng.refresh() for _ in range(5)])[1] / 5
        stats["refresh_device_ms"] = device_ms(eng.refresh)
    return answers, launches, stats


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
    if l_table["spmm_mean"] == 0 or l_table["gather_mean"] != 0:
        raise AssertionError(f"{label}: the table tier launched {l_table}")
    if l_sampled["gather_mean"] == 0 or l_sampled["spmm_mean"] != 0:
        raise AssertionError(f"{label}: the sampled tier launched {l_sampled}")
    main_launches["spmm_mean"] += l_table["spmm_mean"]
    main_launches["gather_mean"] += l_sampled["gather_mean"]

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
        on_card = model(graph.features, fr).cpu()
        cpu_model = copy.deepcopy(model).to("cpu")
        on_cpu = cpu_model(graph.features.cpu(), fr.to("cpu"))
    np.testing.assert_allclose(on_card.numpy(), on_cpu.numpy(), atol=1e-4,
                               err_msg=f"{label}: card forward != CPU forward")
    print(f"   {label}: covering fanout {max_deg} sampled == table; card == CPU "
          f"forward (max diff {float((on_card - on_cpu).abs().max()):.3g})")


def step_device_ms(trainer, iters: int = 10) -> tuple[float, list]:
    """Device time of one training step (profiler, summed over kernels) and
    the four kernels that take most of it."""
    seeds = next(trainer.batches())
    by_name = device_profile(lambda: trainer.step(seeds), iters=iters)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), [(k.split("(")[0][-48:], v) for k, v in top]


def train_preset(name, root, main_launches, overrides=None, graph=None) -> dict:
    """``run_preset`` (given ``graph``, the preset's ``Trainer`` on it) with
    the launch counters set to 0 just before it and read just after; checks
    the launches per step and that the losses are finite."""
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
    evals = 0 if cfg.train.eval_fanouts is None else 1  # the sampled evaluation
    route = "gather_mean_dma" if cfg.model.gather_impl == "dma" else "gather_mean"
    want = {name_: 0 for name_ in KERNELS}
    want.update({route: steps + evals, "scatter_mean": steps})
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


def check_learning(name, result) -> dict:
    losses = result["losses"]
    print(f"   {name}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (bar: below "
          f"{0.7 * losses[0]:.4f}); val micro-F1 {result['val_micro_f1']:.4f} "
          f"(bar: above 0.5)")
    if not (losses[-1] < 0.7 * losses[0] and result["val_micro_f1"] > 0.5):
        raise AssertionError(f"{name}: the run did not learn")
    host_ms = result["mean_step_time"] * 1e3
    dev_ms, top = step_device_ms(result["trainer"])
    stats = dict(host_ms_per_step=host_ms, device_ms_per_step=dev_ms,
                 device_idle_share=1.0 - dev_ms / host_ms, top_kernels=top)
    print(f"   {name}: {stats}")
    return stats


def card_vs_cpu_grads(what, model, loss_fn, graph, *args) -> dict:
    """Parameter gradients of ``loss_fn(model, graph, *args)`` on the card
    against a CPU copy of the model on the same inputs, each leaf within
    ``GRAD_RTOL`` of its own largest entry (a leaf with no gradient fails:
    the check would have no power); returns the kernel launches of the
    card's forward and backward."""
    model.zero_grad(set_to_none=True)
    reset_launches()
    loss_fn(model, graph, *args).backward()
    launches = read_launches()
    card = {k: p.grad.cpu() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    cpu_model = copy.deepcopy(model).to("cpu")
    loss_fn(cpu_model, graph.to("cpu"), *(a.to("cpu") for a in args)).backward()
    for k, p in cpu_model.named_parameters():
        scale = float(p.grad.abs().max())
        diff = float((card[k] - p.grad).abs().max())
        print(f"   {what}: grad {k} {tuple(p.shape)}: max |grad| {scale:.4g}, "
              f"max |card - CPU| {diff:.3g} ({diff / scale if scale else float('nan'):.3g}"
              f" of the largest entry)")
        if not (scale > 0 and diff <= GRAD_RTOL * scale):
            raise AssertionError(f"{what}: grad {k}: card differs from the CPU by "
                                 f"{diff:.3g}, its largest entry is {scale:.3g}")
    print(f"   {what}: card == CPU gradients; launches {launches}")
    return launches


def sampled_loss(model, graph, frontier, seeds):
    return model.loss(graph.features, frontier, graph.labels[seeds.long()])


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
        if launches["scatter_mean"] != 1:
            raise AssertionError(f"{label}: the sampled backward did not scatter")
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


def project_first_times(trainers, iters: int = 10) -> dict:
    """Host and device ms of one training step of each preset with layer 0
    projecting first and aggregating first, on the same graph."""
    out = {}
    for name, tr in trainers.items():
        for pf in (True, False):
            cfg = preset_config(PRESET_OF[name],
                                {**OVERRIDES_OF.get(name, {}), "project_first": pf})
            t = Trainer(build_model(cfg, tr.graph), tr.graph, cfg.train)
            seeds = next(t.batches())
            for _ in range(3):
                t.step(seeds)
            _, ms = timed(lambda: [t.step(seeds) for _ in range(iters)])
            dev_ms, _ = step_device_ms(t)
            out[f"{name} project_first={pf}"] = dict(host_ms=ms / iters, device_ms=dev_ms)
    for k, v in out.items():
        print(f"   {k}: host ms per step {v['host_ms']:.3f}, device ms per step "
              f"{v['device_ms']:.3f}")
    return out


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

    kernels = []
    for name, meta in KERNELS.items():
        recs = timings[name]
        head = next(r for r in recs if r["label"] == "pubmed")
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=main_launches[name],
            max_abs_err=errs[name], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shapes=recs,
        ))
        if main_launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # a failed phase: report it and exit without an ok line
        traceback.print_exc()
        sys.exit(1)
