#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--only PHASE[,PHASE...]]

Needs one NVIDIA card, ``nvcc`` and the repository checkout around this
file; without a card (or without the checkout) it exits non-zero and
prints no result.  Phases, each of which must pass:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, all in parallel) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card,
     array-equal, on integer-valued float32 inputs with ~20% +inf at
     shapes that are not tile multiples (and all-+inf blocks), timing
     kernel and plain version with CUDA events and the profiler's
     device time: the witness FW at the
     piece buckets of both main paths ([407, 8, 8], [6, 32, 32],
     [6211, 8, 8], [75, 32, 32]), the dense path's shapes, road64k's
     fragments ([130, 496, 496], out of L2) and the hierarchy's group
     closures ([6 and 3, 1024, 1024]), ragged n, tie-heavy values and
     all-+inf blocks, each shape timed for the register kernel beside
     the blocked one (n <= 64) or the blocked kernel alone (above); the
     dense twoside
     contraction at the dense and top-closure shapes (S_top+1 = 1712)
     through the grouped kernel's identity tables; the distance-only FW
     (kernel 3, fresh and in place on strided tiles: the register route
     at each of its block sizes, the batched blocked route above n = 128
     at [2, 200], [2, 240], [3, 300], [4, 496], an all-+inf batch and
     ragged n), the (min,+) products with and without accumulation (the
     one-to-all GEMV at [1, 480], [1, 1712] and [1, 4614] with B cycled
     out of L2 and warm, the m = 8 / 9 neighbours of its row threshold,
     negative entries), the
     in-place accumulate on views of a padded matrix as the blocked
     schedule's phases 2 (aliased panels) and 3 (band skipped) call it,
     the whole blocked APSP (``ops.fw_apsp`` at n = 1,711 and 4,661,
     events and device time), the witness twoside argmin (out, wx and wy
     array-equal; tie-heavy values from {0, 1, 2}, and road4000's
     serve-shaped scattered boundary rows at q = 16 and 1,024, sorted
     and tie-heavy variants included, with the share of rows tiles the
     kernel cannot skip) and the hub-label merge, dense and through the
     label table's row ids (q = 8 to 4,096 at W = 480, 1,712 and 4,661,
     (0, 0) pads, the sentinel row and repeated ids),
     timed over input copies larger than the L2 together, beside an
     empty launch; and the hierarchy's lift and leg kernels
     (``gather_minplus.cu``, no Pallas counterpart) at road64k's two and
     road250k's four level shapes, q = 1,024 and 24;
  3. small end-to-end references: road_like(900) with 96 seeded hub
     nodes, built and served on the card, equals the same run on the
     CPU (plain versions), table for table (hub tables and sidecars
     included) and answer for answer, densely and at
     ``hierarchy_levels`` 2 and 3: distances, witnesses
     (``query_witness``), hub answers on gated pairs (== ``query`` ==
     Dijkstra), and 64 card witnesses unwound to paths with
     ``path_weight == dist == Dijkstra``; then one refresh epoch (a mixed
     batch of 3% of the edges) through ``refresh_index`` on both, card ==
     CPU on every table and sidecar, the stats, and 64 answers
     (== Dijkstra);
  4. the dense main path at road4000 through
     ``repro_torch.launch.serve``: host build, device build, planner
     warmup, 5 batches of 1024, 64 answers validated against Dijkstra,
     then ``--paths``: 5 batches of 1024 witness queries unwound to
     paths, 64 validated (0 mismatches each); every kernel's launch
     counter is zeroed just before and read just after;
  5. road4000 at hierarchy levels 1, 2 and 3 serves 1,024 array-equal
     answers; then road4000 through ``repro_torch.launch.serve
     --update-batches 3 --update-frac 0.02`` (an ``EpochedEngine``): each
     refreshed epoch == its scratch reweight rebuild (``REFRESHED_FIELDS``
     and the host sidecars), 64 answers == Dijkstra, both witness FW
     kernels launched; a ``--paths`` batch of 1,024 on the last epoch (64
     validated); a staged ``RefreshPipeline`` drain of a 5% batch (32
     answers checked on every epoch it publishes, the last == scratch);
  6. the hierarchical main path at road64k (its preset's 3 levels, with
     2,048 seeded random hub nodes) through the same entry points, with
     the serve CLI's scale gates ``--expect-hierarchy 3 --max-s2-ratio
     0.5`` (as ``scripts/check.sh`` runs the reference), 32 validated, ``--paths`` at one batch of 16 (all validated), then
     ``serve_one_to_all`` from 3 sources against Dijkstra and, from
     4,096 random pairs of hub nodes, the hub-gated pairs through
     ``query_hub`` (== ``query``, 32 == Dijkstra), one ``serve_hub`` call
     on them and its label merge on the real table timed (launches of
     the timing taken back off the counter); counters zeroed just
     before and read just after; then each one-to-all source timed on
     its own (warm, synchronised, Dijkstra excluded); peak device memory
     of the build and of serving; the top closure's witnesses
     (``hierarchy.first_hops`` on the card, plain torch) == the same
     function on CPU copies on 128 seeded rows, the full table timed;
  7. the grouped twoside kernel (compact rows through id tables)
     array-equal to its plain version: random operands in both regimes
     (ragged, all-+inf rows, ties, duplicate and sentinel ids, one
     query's table row each, 32 or 100 entries wide, or a few shared
     ones) and the operands the road4000 and road64k planners hand it
     for a batch of 1,024 (cross_frag at both, road64k's cross_res),
     bounds counted from each input's own finite cells; then two
     refresh epochs on phase 6's road64k index through ``refresh_index``
     (a decrease-only batch of 0.1% of the edges, then a jam of 0.5%),
     counters zeroed around each: each == its scratch reweight rebuild
     with the same hub set, 32 answers, the hub answers and one
     one-to-all source == Dijkstra, both witness FW kernels launched, and
     the jam re-closes the top (``full_fw``: kernels 3 and 4); each
     epoch's ``RefreshStats`` (synchronised stage seconds, top closure)
     and the rebuild's seconds are printed;
 7b. road250k (``_road250k``), the preset's ``"auto"`` hierarchy at its
     full 5 levels, through the same entry points as phase 6 with
     ``--expect-hierarchy 5``, a host build on every core, 32
     validated, ``--paths`` at one batch of 4, one-to-all from 2
     sources and 2,048 hub nodes (0 mismatches each); its shapes (n, S,
     levels, nsf, S2, overlay bytes) == the reference's record in
     ``BENCH_serve.json``, printed per level; the top witnesses on the
     card == the CPU's on 128 rows; kernels 1 (fragments [246, 992,
     992], group closures [10, 2048, 2048] and [4, 4096, 4096]), 2
     (cross_frag against S_top+1 = 4,661) and 7 (the hub check at W =
     4,661) timed on its own tables; one 1% traffic epoch through
     ``refresh_index`` (16 answers == Dijkstra before and after, == its
     scratch rebuild, ``RefreshStats`` and the ``first_hops`` span
     printed); every kernel of its main path must launch;
  8. the live serving runtime through ``repro_torch.launch.serve``'s
     ``build_engine`` and ``live_loop`` (``serve --live``): road4000
     with a 4-worker parallel host build (== serial) streamed into the
     device build, 3 s of Zipf traffic at 4,000 qps through the cache,
     the hub tier (256 nodes) and the planner while 3 refresh rounds run
     on the engine's refresh stream (0 mismatches against each
     response's epoch oracle, more than one epoch served, the longest
     serving gap under ``ROAD4000_MAX_GAP_S``), then 2,000, 8,000 and
     32,000 qps offered without refresh; road64k on phase 6's host index
     with 2,048 Zipf-pool hub nodes: cache off (the label tier serves
     exactly the ``ROAD64K_LIVE_GATED`` pairs the hub gate admits),
     cache on, and 12 s beside one refresh epoch (its ``top_closure``
     and the serving gap beside it are recorded);
     counters zeroed around each run, and no kernel library built or
     loaded during one;
 8b. the bench gate (``_gate``): ``python -m
     repro_torch.launch.bench_gate`` and its ``--live``, ``--refresh``
     and ``--host-build`` sections at road4000 against the committed
     ``BENCH_torch_serve.json`` (the median of the last 5 card records
     of the same configuration and card); each section of
     ``GATED_SECTIONS`` must pass, the others run with their numbers
     printed; the fresh ``serve_live`` records carry every tier and
     histogram field; ``--inject-slowdown 10`` must exit 1.  Each run
     is a serve CLI process of its own on the road4000 path that phase
     4 counts launches on;
  9. the sharded path (``_sharded``) on phases 4 and 6's indices:
     road4000 through ``serve --mode fused`` and ``--mode sharded`` (5
     batches of 1,024, 64 validated, 0 mismatches); road64k through ``serve_sharded`` on a one-card mesh
     and on ``cuda:0`` repeated four times, batches of 1,024 and 1,000
     (ragged), == ``serve_step`` == the planner, 32 == Dijkstra; 64
     road4000 answers == the port's ``DislandEngine``, also served from
     a copy of the index on the CPU (replicas copied to the card, and on
     a mesh of the CPU and the card); the sharded build
     (``fw_fragments_sharded`` == ``frag_apsp``, ``super_apsp_sharded``
     == the dense ``d_super`` at road4000 and == ``ops.fw_apsp`` of the
     overlay at road64k); counters zeroed around it (it must launch the
     grouped twoside and kernel 3's blocked route ``fw_dist_blocked``
     with its three kernels), then the sharded build and kernel 3 at
     [130, 496, 496] timed beside the witness ``fw_next_blocked``;
 10. the training path (``_train``; no kernel of the port runs in it:
     counters zeroed around it must read 0): card == CPU on reduced
     float32 granite-moe and granite-8b (loss, every gradient, one AdamW
     step; ``allow_tf32`` off and printed); granite-moe-1b-a400m at its
     published dims through ``repro_torch.launch.train`` at seq 4,096
     (6 steps, a checkpoint every 3, the step-6 checkpoint == the run's
     state bit for bit, then 2 more steps in a fresh process that
     resumes it; finite losses, the last below the first), then prefill
     of a 4,096-token prompt and 16 decode steps each == the prefill of
     the extended prompt within ``DECODE_REL_TOL``; wide-deep at its
     published dims (40 x 1,000,000-row tables) for 4 steps at the
     ``train_batch`` shape of 65,536; each of the ten archs at
     ``--reduced`` for 2 steps; median step seconds, rates and peak
     device memory per run;
 11. the sharded GNN forwards (``_gnn_sharded``; no kernel of the port:
     counters zeroed around it must read 0), at published widths:
     graphcast (16 layers, d 512) at ``minibatch_lg`` (n 169,984, e
     168,960, d_feat 602) and dimenet (6 blocks, d 128) at ``molecule``
     (128 molecules, n 4,096, e 16,384, whole molecules per shard), each
     in float32 through ``models.gnn.forward_loss`` with ``sharded`` on
     the one-card mesh and on ``cuda:0`` x 4 (the owner layout: each
     shard's nodes, their incoming edges, dst shard-local) == the dense
     forward on the same graph (loss and every gradient leaf within
     ``GNN_RTOL``), then 3 steps of the cell's bf16 step
     (``launch.cells.build_cell``): step s, peak MiB, finite losses;
 12. the dry runs (``_dryrun``): ``repro_torch.launch.dryrun --all
     --mesh both`` (40 cells x the single and multipod production meshes
     on ``meta``), started before road64k's live run in its own processes
     at nice 19 (``DRYRUN_WORKERS``; it needs no card), waited for here;
     every
     record ``ok``; then ``launch.dryrun_disland``; records in
     ``chiprun_out/dryrun_torch/``; then ``dryrun_vs_card``: the ``meta``
     peak (``launch.opanalysis``) over ``torch.cuda.max_memory_allocated``
     above the bytes held before, for the wide-deep ``train_batch`` step
     and road4000's ``serve_step`` at q = 1,024 (kernel 2 launched),
     each within ``VS_CARD_RANGE``.  Phase 4's road4000 run also writes
     its records with ``serve --json`` to a temporary history and reads
     them back;
 13. the paper's experiments (``_paper``): Exp-5, Exp-7 and Exp-8 of
     ``repro_torch.paper.tables`` on the card at the reference's sizes
     (road_like(6000) and road_like(2500)), counters zeroed just before
     and read just after (kernels 1, 2 and 6 must launch): every Exp-5
     bucket's batched ``serve_step`` answers == Dijkstra, ``match == 1``
     in every Exp-7 round, ``exact == 1`` in Exp-8; the CSV rows printed;
 14. the ``kernels`` JSON line (launches summed over the main paths of
     phases 4, 6 and 7b, the refresh epochs of phases 5, 7 and 7b, the
     live
     runs of phase 8, the sharded path of phase 9 and the paper phase
     13, those of phases 8, 9, 13 and 7b also apart as
     ``live_launches``, ``sharded_launches``, ``paper_launches`` and
     ``road250k_launches``;
     together they must launch both witness FW kernels, the
     grouped twoside, the label merge through row ids, the in-place
     accumulate and ``fw_dist_blocked``, and never the fresh-output
     accumulate or the dense label merge; times and bounds from phases 2, 7 and 9),
     the card's name and power limit from nvidia-smi, and the
     ``{"ok": true, ...}`` line last.

Details of every case go to ``chiprun_out/chip_smoke.json``, with the
tally of the profiler windows behind every device time; the road4000
live run's metrics snapshot and Chrome trace to
``chiprun_out/live_road4000_{metrics,trace}.json``.  The old
twoside path (rows scattered at their ids, then the first dense kernel)
is timed against the grouped kernel by ``scripts/kernel_ab.py
--twoside`` on a parent checkout.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM bandwidth and float32 rate outside the
# tensor cores ((min,+) has no tensor-core form)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()                                       # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


#: profiler windows behind every ``_device_ms`` reading: all, those that
#: saw no kernel, those that saw fewer kernels than another window of
#: the same reading (left out of it), and, for each reading with such a
#: window, its ordinal and the kernels each window saw
WINDOWS = {"readings": 0, "windows": 0, "empty": 0, "partial": 0,
           "drops_at": []}
#: seconds a profiler window waits before its first launch and after its
#: last kernel
_SETTLE_S = 0.005


def _device_ms(fn, reps: int) -> float | None:
    """Device time per call of ``fn``: the summed time of every kernel it
    launches, from torch.profiler's CUDA activity (host enqueue gaps
    excluded, unlike ``_time_ms``).  Each window waits ``_SETTLE_S``
    after the profiler starts and after its last kernel ends, so that no
    launch races the profiler's start or stop.  A window can still see
    fewer kernels than the others (cause not found): of three windows,
    the median of those that saw the most kernels (tallied in
    ``WINDOWS``); None if none saw any."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(_SETTLE_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(_SETTLE_S)
        ev = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
        us = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0)
                 for e in ev)
        seen.append((sum(e.count for e in ev), us / reps / 1e3))
    most = max(n for n, _ in seen)
    WINDOWS["readings"] += 1
    WINDOWS["windows"] += 3
    WINDOWS["empty"] += sum(n == 0 for n, _ in seen)
    WINDOWS["partial"] += sum(0 < n < most for n, _ in seen)
    if any(n < most for n, _ in seen):
        WINDOWS["drops_at"].append([WINDOWS["readings"]]
                                   + [n for n, _ in seen])
    return (statistics.median(ms for n, ms in seen if n == most)
            if most else None)


def _int_inf(shape, rng, inf_frac=0.2):
    import numpy as np
    x = rng.integers(0, 100, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over cells where either is finite; a cell that is
    +inf on one side only counts as inf."""
    import torch
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def _fw_input(b, n, kind, all_inf):
    """[b, n, n] on the card: integers with ~20% +inf, or ("ties")
    values from {0, 1, 2} with 60% +inf, so that many paths tie and the
    first hops depend on the pivot order; batch entries ``all_inf`` all
    +inf."""
    import numpy as np
    import torch
    rng = np.random.default_rng(b * 7919 + n)
    if kind == "ties":
        d_np = rng.integers(0, 3, (b, n, n)).astype(np.float32)
        d_np[rng.random(d_np.shape) < 0.6] = np.inf
    else:
        d_np = _int_inf((b, n, n), rng)
    d_np[list(all_inf)] = np.inf
    return torch.from_numpy(d_np).cuda()


def _check_fw(cases, out):
    """(label, b, n, kind, all_inf): the witness FW variants against the
    plain version, dist and nxt array-equal, each timed in this call
    (CUDA events and device time): n <= REG_MAX_N the register kernel
    (the main path's) and the blocked one, above it the blocked kernel
    (the main path's)."""
    import torch
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import ops
    for label, b, n, kind, all_inf in cases:
        d = _fw_input(b, n, kind, all_inf)
        want = ops.fw_batch_next(d, force="ref")
        big = b * n * n > 4_000_000
        plain_ms = _time_ms(lambda: ops.fw_batch_next(d, force="ref"),
                            1 if big else 3)
        bound, by = _bound_ms(12.0 * b * n * n, 2.0 * b * n ** 3)
        for kernel in ((fw.fw_next_reg_cuda, fw.fw_next_blocked_cuda)
                       if n <= fw.REG_MAX_N else (fw.fw_next_blocked_cuda,)):
            got = kernel(d)
            torch.cuda.synchronize()
            dist_ok = torch.equal(got[0], want[0])
            nxt_ok = torch.equal(got[1], want[1])
            _record(out, {
                "case": label, "kernel": kernel.__name__, "b": b, "n": n,
                "kind": kind, "dist_equal": dist_ok, "nxt_equal": nxt_ok,
                "max_abs_err": _max_abs_err(got[0], want[0]),
                "ms": _time_ms(lambda: kernel(d), 2 if big else 10),
                "device_ms": _device_ms(lambda: kernel(d), 2 if big else 10),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by},
                dist_ok and nxt_ok)


def _check_twoside(cases, out):
    """(label, q, k, inf_frac): the dense contraction on the card, the
    grouped kernel with identity tables (``minplus_twoside_cuda``),
    array-equal to the plain version."""
    import functools

    import numpy as np
    import torch
    from repro_torch.kernels import minplus_twoside as ts
    from repro_torch.kernels import ops
    for label, q, k, inf_frac in cases:
        rng = np.random.default_rng(q * 31 + k)
        rows, d, rowt = (torch.from_numpy(_int_inf(s, rng, f)).cuda()
                         for s, f in (((q, k), inf_frac), ((k, k), 0.2),
                                      ((q, k), 0.2)))
        got = ts.minplus_twoside_cuda(rows, d, rowt)
        want = ops.minplus_twoside(rows, d, rowt, force="ref")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        kern = functools.partial(ts.minplus_twoside_cuda, rows, d, rowt)
        # work this data needs: (q, x, y) triples whose three terms are
        # all finite (the +inf ones cannot move a min), 2 ops each
        fin = [torch.isfinite(x).double() for x in (rows, d, rowt)]
        triples = float(((fin[0] @ fin[1]) * fin[2]).sum())
        nbytes = 4.0 * (rows.numel() + d.numel() + rowt.numel() + q)
        bound, by = _bound_ms(nbytes, 2.0 * triples)
        _record(out, {
            "case": label, "kernel": "minplus_twoside_cuda", "q": q, "k": k,
            "equal": ok, "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(kern, 10), "device_ms": _device_ms(kern, 10),
            "plain_ms": _time_ms(lambda: ops.minplus_twoside(
                rows, d, rowt, force="ref"), 2),
            "bound_ms": bound, "bound_by": by, "finite_triples": triples},
            ok)


_ROAD4000: dict = {}


def _serve_rows(q, kind, rng):
    """(rows, d, rowt) as road4000's witness combine gets them: each
    row is one endpoint's boundary-row entries scattered over the S+1
    super ids (``device_engine._scatter_rows`` of ``brow[frag, pos]`` at
    ``bnd_super[frag]``, at most mb = 32 finite entries a row), d the
    dense overlay, for q random pairs.  "serve sorted" orders the pairs
    by the first finite x of their rows; "serve ties" keeps the finite
    pattern and draws the finite values (d's too) from {0, 1, 2}."""
    import torch
    from repro_torch.core import device_engine as de
    if not _ROAD4000:
        from repro_torch.core.graph import road_like
        from repro_torch.core.supergraph import build_index
        _ROAD4000["dix"] = de.build_device_index(
            build_index(road_like(4000, seed=0)), device="cuda",
            hierarchy_levels=1)
    dix = _ROAD4000["dix"]
    n = dix.agent_of.shape[0]
    s, t = (torch.from_numpy(rng.integers(0, n, q)).cuda() for _ in "st")
    _ds, _dt, fs, ft, ps, pt, _valid = de._ends(dix, s, t)
    s1 = dix.d_super.shape[0]
    rows = de._scatter_rows(dix.brow[fs, ps], dix.bnd_super[fs].long(), s1)
    rowt = de._scatter_rows(dix.brow[ft, pt], dix.bnd_super[ft].long(), s1)
    d = dix.d_super.clone()
    if kind == "serve sorted":
        x = torch.arange(s1, device=rows.device)
        first = torch.where(torch.isfinite(rows), x, s1).amin(dim=1)
        order = torch.argsort(first, stable=True)
        rows, rowt = rows[order].contiguous(), rowt[order].contiguous()
    if kind == "serve ties":
        gen = torch.Generator(device="cuda").manual_seed(q)
        for x in (rows, d, rowt):
            small = torch.randint(0, 3, x.shape, generator=gen,
                                  device=x.device).float()
            x.copy_(torch.where(torch.isfinite(x), small, x))
    return rows, d, rowt


def _argmin_inputs(q, k, kind, rng):
    """(rows, d, rowt) on the card: integers with ~20% +inf ("ragged"),
    all-+inf query rows ("inf"), values from {0, 1, 2} so that many
    cells tie at the minimum ("ties"), or road4000's serve-shaped rows
    (kinds "serve...", ``_serve_rows``; k is its S+1 = 480)."""
    import numpy as np
    import torch
    if kind.startswith("serve"):
        return _serve_rows(q, kind, rng)
    shapes = ((q, k), (k, k), (q, k))
    if kind == "ties":
        arrs = [rng.integers(0, 3, s).astype(np.float32) for s in shapes]
    else:
        arrs = [_int_inf(s, rng, 1.0 if (kind == "inf" and i == 0) else 0.2)
                for i, s in enumerate(shapes)]
    return [torch.from_numpy(x).cuda() for x in arrs]


def _live_tiles(rows) -> float:
    """Share of the witness kernel's 64 x 32 rows tiles that hold a
    finite entry (the others skip their d load and inner loop)."""
    import torch
    q, k = rows.shape
    qp, kp = -(-q // 64) * 64, -(-k // 32) * 32
    f = torch.zeros((qp, kp), dtype=torch.bool, device=rows.device)
    f[:q, :k] = torch.isfinite(rows)
    return float(f.reshape(qp // 64, 64, kp // 32, 32).any(dim=3)
                 .any(dim=1).double().mean())


def _check_twoside_argmin(cases, out):
    """(label, q, k, kind): the witness twoside kernel against its plain
    version, out, wx and wy array-equal."""
    import functools

    import numpy as np
    import torch
    from repro_torch.kernels import minplus_twoside as ts
    from repro_torch.kernels import ops
    for label, q, k, kind in cases:
        rows, d, rowt = _argmin_inputs(q, k, kind,
                                       np.random.default_rng(q * 37 + k))
        got = ts.minplus_twoside_argmin_cuda(rows, d, rowt)
        want = ops.minplus_twoside_argmin(rows, d, rowt, force="ref")
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        fin = [torch.isfinite(x).double() for x in (rows, d, rowt)]
        triples = float(((fin[0] @ fin[1]) * fin[2]).sum())
        nbytes = 4.0 * (rows.numel() + d.numel() + rowt.numel() + 3 * q)
        bound, by = _bound_ms(nbytes, 2.0 * triples)
        kern = functools.partial(ts.minplus_twoside_argmin_cuda, rows, d,
                                 rowt)
        _record(out, {
            "case": label, "kernel": "minplus_twoside_argmin_cuda", "q": q,
            "k": k, "kind": kind, "equal": ok,
            "splits": ts.x_splits(q, k, k),
            "finite_per_row": float(torch.isfinite(rows).sum(dim=1).double()
                                    .mean()),
            "live_rows_tiles": _live_tiles(rows),
            "max_abs_err": _max_abs_err(got[0], want[0]),
            "ms": _time_ms(kern, 10), "device_ms": _device_ms(kern, 10),
            "plain_ms": _time_ms(lambda: ops.minplus_twoside_argmin(
                rows, d, rowt, force="ref"), 2),
            "bound_ms": bound, "bound_by": by, "finite_triples": triples},
            ok)


#: bytes of inputs a timed call cycles through, so each call finds its
#: own inputs out of the card's 50 MB L2 (as a serve batch finds them)
_COLD_BYTES = 128 << 20


def _cold_minplus(minplus, a, b):
    """(fn, copies): fn() = minplus(a, b') with b' the next of ``copies``
    copies of b that together exceed the L2 (at least 5), one a call, so
    each call reads its B from HBM (kernel 5's one-to-all reading)."""
    bs = [b.clone() for _ in range(
        max(5, -(-_COLD_BYTES // (4 * b.numel()))))]
    turn = iter(range(1 << 30))

    def fn():
        return minplus(a, bs[next(turn) % len(bs)])
    return fn, len(bs)


def _check_label_merge(cases, out):
    """(label, q, w, inf_row): the label-merge kernel against its plain
    version, array-equal.  Timed over copies of the inputs larger than
    the L2 together, one copy a call, so no call re-reads the last one's
    inputs from L2."""
    import numpy as np
    import torch
    from repro_torch.kernels import label_merge as lm
    from repro_torch.kernels import ops
    for label, q, w, inf_row in cases:
        rng = np.random.default_rng(q * 13 + w)
        labs = _int_inf((q, w), rng, 0.1)
        labt = _int_inf((q, w), rng, 0.1)
        if inf_row is not None:
            labs[inf_row] = np.inf
        labs, labt = torch.from_numpy(labs).cuda(), torch.from_numpy(
            labt).cuda()
        got = lm.label_merge_cuda(labs, labt)
        want = ops.label_merge(labs, labt, force="ref")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        bound, by = _bound_ms(8.0 * q * w + 4.0 * q, 2.0 * q * w)
        n = min(64, max(2, -(-_COLD_BYTES // (8 * q * w))))
        copies = [(labs.clone(), labt.clone()) for _ in range(n)]
        turn = iter(range(1 << 30))

        def cold():
            a, b = copies[next(turn) % n]
            return lm.label_merge_cuda(a, b)
        _record(out, {
            "case": label, "kernel": "label_merge_cuda", "q": q, "w": w,
            "equal": ok, "max_abs_err": _max_abs_err(got, want),
            "copies": n, "ms": _time_ms(cold, 50),
            "device_ms": _device_ms(cold, 50),
            "hot_device_ms": _device_ms(
                lambda: lm.label_merge_cuda(labs, labt), 50),
            "plain_ms": _time_ms(lambda: ops.label_merge(labs, labt,
                                                         force="ref"), 10),
            "bound_ms": bound, "bound_by": by}, ok)


#: the indexed merge case the ``kernels`` line reports
MERGE_ROWS_MAIN = "rows q=1024 W=1712 (2,035 rows)"

#: (label, q, W, table rows, ids): kernel 7 through row ids at the hub
#: tier's widths (road4000's W = 480 with 257 label rows, road64k's
#: 1,712 with 2,035, road250k's 4,661 with 2,049), a batch of 1,024;
#: road250k's hub call (2,070 gated pairs padded to 4,096); the live
#: flush sizes; a small ragged case (``_merge_rows_inputs``)
MERGE_ROWS_CASES = (
    ("rows q=1024 W=480 (257 rows)", 1024, 480, 257, "random"),
    (MERGE_ROWS_MAIN, 1024, 1712, 2035, "random"),
    ("rows q=1024 W=4661 (2,049 rows)", 1024, 4661, 2049, "random"),
    ("rows q=4096 W=4661 half pads (2,049 rows)", 4096, 4661, 2049,
     "pads"),
    ("rows q=8 W=480 (live flush)", 8, 480, 257, "random"),
    ("rows q=256 W=480 (live flush)", 256, 480, 257, "random"),
    ("rows q=37 W=299 sentinel, repeated ids", 37, 299, 41, "sentinel"))


def _merge_rows_inputs(q, w, h, kind, rng):
    """(rows [h, w], ids_s, ids_t [q] int32) on the card: integers with
    ~10% +inf, the last row the all-+inf sentinel; ids uniform over the
    h rows ("random"), the same with the second half of the batch (0, 0)
    pads, as ``query_hub`` pads a batch to a power of two ("pads"), or
    from 8 rows and the sentinel, so that ids repeat ("sentinel")."""
    import numpy as np
    import torch
    rows = _int_inf((h, w), rng, 0.1)
    rows[h - 1] = np.inf
    if kind == "sentinel":
        ids = rng.integers(0, 9, (2, q))
        ids[ids == 8] = h - 1
    else:
        ids = rng.integers(0, h, (2, q))
    if kind == "pads":
        ids[:, q // 2:] = 0
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    return torch.from_numpy(rows).cuda(), ids[0].clone(), ids[1].clone()


def _merge_rows_times(rows, ids_s, ids_t) -> dict:
    """Kernel 7 through row ids on (rows, ids_s, ids_t), timed with the
    table out of L2 (copies of ``rows``, together larger than the L2, one
    a call, so a call reads every row it needs from HBM): device and
    CUDA-event ms; warm device ms on ``rows`` itself; the route it replaced (two
    gathers, then the dense merge: every kernel of it) from the same
    copies; the bound (the distinct rows the ids reach, 8 bytes of ids
    and 4 of output a query) and the dense route's bound 8qW + 4q."""
    import functools

    import torch
    from repro_torch.kernels import label_merge as lm
    from repro_torch.kernels import ops
    q, w = ids_s.shape[0], rows.shape[1]
    distinct = int(torch.unique(torch.cat([ids_s, ids_t])).numel())
    bound, by = _bound_ms(4.0 * distinct * w + 12.0 * q, 2.0 * q * w)
    n = min(1024, max(2, -(-_COLD_BYTES // (4 * rows.numel()))))
    copies = [rows.clone() for _ in range(n)]
    turn = iter(range(1 << 30))

    def cold():
        return lm.label_merge_rows_cuda(copies[next(turn) % n], ids_s,
                                        ids_t)

    def gathers():
        r = copies[next(turn) % n]
        return ops.label_merge(r[ids_s.long()], r[ids_t.long()])
    return {
        "q": q, "w": w, "table_rows": rows.shape[0],
        "distinct_rows": distinct, "copies": n, "team": lm.team(q, w),
        "ms": _time_ms(cold, 50), "device_ms": _device_ms(cold, 50),
        "hot_device_ms": _device_ms(functools.partial(
            lm.label_merge_rows_cuda, rows, ids_s, ids_t), 50),
        "gather_route_device_ms": _device_ms(gathers, 50),
        "bound_ms": bound, "bound_by": by,
        "dense_bound_ms": _bound_ms(8.0 * q * w + 4.0 * q, 2.0 * q * w)[0]}


def _check_label_merge_rows(cases, out) -> dict:
    """(label, q, W, table rows, kind): kernel 7 through row ids against
    its plain version, array-equal, and through the dense entry on the
    gathered rows (``_merge_rows_inputs``), timed by
    ``_merge_rows_times``.  Returns the empty kernel's device and event
    ms on one block and on the grid of a q = 1,024 merge (1,024 blocks):
    the fixed cost of a launch, which the merge's time is read beside."""
    import functools

    import numpy as np
    import torch
    from repro_torch.kernels import label_merge as lm
    from repro_torch.kernels import ops
    for label, q, w, h, kind in cases:
        rng = np.random.default_rng(q * 7 + w)
        rows, ids_s, ids_t = _merge_rows_inputs(q, w, h, kind, rng)
        want = ops.label_merge_rows(rows, ids_s, ids_t, force="ref")
        got = [lm.label_merge_rows_cuda(rows, ids_s, ids_t),
               lm.label_merge_cuda(rows[ids_s.long()], rows[ids_t.long()])]
        torch.cuda.synchronize()
        ok = all(torch.equal(x, want) for x in got)
        _record(out, {
            "case": label, "kernel": "label_merge_rows_cuda", "kind": kind,
            "equal": ok, "max_abs_err": max(_max_abs_err(x, want)
                                            for x in got),
            **_merge_rows_times(rows, ids_s, ids_t),
            "plain_ms": _time_ms(lambda: ops.label_merge_rows(
                rows, ids_s, ids_t, force="ref"), 10)}, ok)
        del rows, ids_s, ids_t
        torch.cuda.empty_cache()
    floor = {}
    for blocks in (1, 1024):
        fn = functools.partial(lm.empty_launch_cuda, blocks)
        floor[f"blocks={blocks}"] = {"device_ms": _device_ms(fn, 50),
                                     "ms": _time_ms(fn, 50)}
    print(f"  empty launch: {floor}")
    return {"empty_launch": floor}


#: (graph, index) of each main path, for the serve-shaped grouped cases
_BUILT: dict = {}
#: (host index, build plan, hub nodes) of each main path, for the refresh
#: phases
_HOST: dict = {}


def _grouped_random(kind, q, m, k, groups, rng):
    """Grouped operands on the card: rows [q, m] and id tables into a
    [k, k] closure whose last row and column are +inf (the sentinel
    id), integers with ~20% +inf.  ``groups`` table rows per side (0: one
    per query, as the dense call site passes them); kinds "all-inf"
    (every other row_s and every fourth row_t all +inf), "ties" (values
    from {0, 1, 2}, no +inf), "dup" (ids from a range of 9, a third of
    each table row the sentinel, row_t 40 entries wide)."""
    import numpy as np
    import torch
    hi, frac = (3, 0.0) if kind == "ties" else (100, 0.2)

    def ints(shape):
        x = rng.integers(0, hi, size=shape).astype(np.float32)
        x[rng.random(shape) < frac] = np.inf
        return x
    mt = 40 if kind == "dup" else m
    d = ints((k, k))
    d[k - 1], d[:, k - 1] = np.inf, np.inf
    ns = nt = groups or q
    top = 9 if kind == "dup" else k - 1
    tab_s = rng.integers(0, top, (ns, m)).astype(np.int32)
    tab_t = rng.integers(0, top, (nt, mt)).astype(np.int32)
    if kind == "dup":
        tab_s[:, : m // 3], tab_t[:, : mt // 3] = k - 1, k - 1
    row_s, row_t = ints((q, m)), ints((q, mt))
    if kind == "all-inf":
        row_s[::2], row_t[::4] = np.inf, np.inf
    gs = (rng.integers(0, ns, q) if groups else np.arange(q)).astype(np.int64)
    gt = (rng.integers(0, nt, q) if groups else np.arange(q)).astype(np.int64)
    return tuple(torch.from_numpy(x).cuda() for x in (
        row_s, gs, tab_s, d, row_t, gt, tab_t))


def _capture_grouped(dix, n: int, seed: int) -> dict:
    """The operands the planner (the card's default "scatter" layout)
    hands ``ops.minplus_twoside_grouped`` for one batch of 1,024 random
    pairs: the widest call of each call site, by site name."""
    import numpy as np
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    s, t = rng.integers(0, n, 1024), rng.integers(0, n, 1024)
    calls: dict = {}
    real = ops.minplus_twoside_grouped

    def record(*args, force=None):
        site = sys._getframe(1).f_code.co_name
        if site not in calls or args[0].shape[0] > calls[site][0].shape[0]:
            calls[site] = tuple(a.clone() for a in args)
        return real(*args, force=force)
    ops.minplus_twoside_grouped = record
    try:
        QueryPlanner(dix).query(s, t)
    finally:
        ops.minplus_twoside_grouped = real
    return calls


def _grouped_work(args) -> tuple[float, float]:
    """(bytes, finite cells) the grouped contraction of ``args`` needs:
    rows, tables, groups and the answer once, and each closure cell some
    query's table pair reaches once; the (q, i, j) cells whose three
    terms are all finite (an +inf term cannot move a min)."""
    import torch
    row_s, gs, tab_s, d, row_t, gt, tab_t = args
    q = row_s.shape[0]
    fs, ft = torch.isfinite(row_s).double(), torch.isfinite(row_t).double()
    ids_s, ids_t = tab_s[gs].long(), tab_t[gt].long()
    cells = 0.0
    for i in range(0, q, 64):
        blk = torch.isfinite(d[ids_s[i:i + 64, :, None],
                               ids_t[i:i + 64, None, :]]).double()
        cells += float(torch.einsum("qi,qij,qj->", fs[i:i + 64], blk,
                                    ft[i:i + 64]))
    reach = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    for a, b in torch.unique(torch.stack([gs, gt]), dim=1).T.tolist():
        reach[tab_s[a].long()[:, None], tab_t[b].long()[None, :]] = True
    nbytes = (4.0 * (row_s.numel() + row_t.numel() + tab_s.numel()
                     + tab_t.numel() + q) + 16.0 * q
              + 4.0 * float(reach.sum()))
    return nbytes, cells


def _check_twoside_grouped(cases, out):
    """(label, operands): the grouped kernel against its plain version,
    array-equal, timed by CUDA events and device time."""
    import functools

    import torch
    from repro_torch.kernels import minplus_twoside as ts
    from repro_torch.kernels import ops
    for label, args in cases:
        row_s, gs, tab_s, d, row_t, gt, tab_t = args
        got = ts.minplus_twoside_grouped_cuda(*args)
        want = ops.minplus_twoside_grouped(*args, force="ref")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        kern = functools.partial(ts.minplus_twoside_grouped_cuda, *args)
        nbytes, cells = _grouped_work(args)
        bound, by = _bound_ms(nbytes, 2.0 * cells)
        regime, sort, splits = ts.grouped_plan(
            row_s.shape[0], row_s.shape[1], row_t.shape[1], tab_s.shape[0],
            tab_t.shape[0])
        _record(out, {
            "case": label, "kernel": "minplus_twoside_grouped_cuda",
            "q": row_s.shape[0], "width_s": row_s.shape[1],
            "width_t": row_t.shape[1],
            "k": d.shape[0], "table_rows": [tab_s.shape[0], tab_t.shape[0]],
            "live_pairs": int(torch.unique(torch.stack([gs, gt]),
                                           dim=1).shape[1]),
            "regime": regime, "sorted": sort, "splits": splits,
            "equal": ok, "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(kern, 20), "device_ms": _device_ms(kern, 20),
            "plain_ms": _time_ms(lambda: ops.minplus_twoside_grouped(
                *args, force="ref"), 2),
            "bound_ms": bound, "bound_by": by, "finite_cells": cells,
            "cells": float(row_s.shape[0] * row_s.shape[1] * row_t.shape[1]),
            "bytes": nbytes}, ok)


def _grouped_cases() -> list:
    """Random operands in both regimes, then the serve-shaped ones
    captured from the road4000 and road64k main paths' indexes (the
    cross_frag bucket's dense or hierarchical combine, and road64k's
    cross_res bucket)."""
    import numpy as np
    rng = np.random.default_rng(15)
    cases = [(f"grouped {kind} q={q} m={m} G={g or 'q'} K={k}",
              _grouped_random(kind, q, m, k, g, rng))
             for kind, q, m, k, g in (
                 ("ragged", 1024, 32, 480, 0), ("ties", 1024, 48, 480, 0),
                 ("all-inf", 256, 64, 480, 0), ("ragged", 1024, 100, 1712, 0),
                 ("ragged", 1024, 592, 1712, 4), ("ties", 512, 300, 1712, 6),
                 ("all-inf", 256, 592, 1712, 4), ("dup", 300, 100, 1712, 5),
                 ("ragged", 16, 592, 1712, 4))]
    g4, dix4 = _BUILT["road4000"]
    calls = _capture_grouped(dix4, g4.n, 21)
    cases.append(("serve road4000 cross_frag (_combine_mid)",
                  calls["_combine_mid"]))
    g64, dix64 = _BUILT["road64k"]
    calls = _capture_grouped(dix64, g64.n, 21)
    cases.append(("serve road64k cross_frag (_combine_mid_h)",
                  calls["_combine_mid_h"]))
    cases.append(("serve road64k cross_res (serve_cross_res)",
                  calls["serve_cross_res"]))
    return cases


#: (label, units, groups, m2, slots, next width) of the hierarchy's
#: level shapes: road64k's two (fragment rows of 64 over 130 fragments,
#: then 440) and road250k's four (rows of 96 over 246 fragments, then
#: 1,072, 1,624 and 2,056 over its groups)
GATHER_LEVELS = (
    ("road64k-l1", 130, 6, 1024, 64, 440),
    ("road64k-l2", 7, 3, 1024, 440, 592),
    ("road250k-l1", 246, 10, 2048, 96, 1072),
    ("road250k-l2", 11, 7, 2048, 1072, 1624),
    ("road250k-l3", 8, 4, 4096, 1624, 2056),
    ("road250k-l4", 5, 2, 4096, 2056, 2336),
)


def _gather_level(units, groups, m2, slots, width, rows, seed):
    """One level's operands on the card: overlay ids g * m2 + p in
    ``groups`` groups (the sentinel id in the sentinel group); ``units``
    table rows (the last all-sentinel), each a run of distinct ids of one
    group, then sentinel slots; the lift rows [G + 1, m2, width] and the
    closures [G + 1, m2, m2] integers with ~20% +inf, the sentinel
    group's +inf; ``rows`` rows finite (~80%) on their valid slots only,
    every eleventh all +inf; units uniform."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    S = groups * m2
    gof = np.concatenate([np.repeat(np.arange(groups), m2), [groups]])
    pof = np.concatenate([np.tile(np.arange(m2), groups), [0]])
    tab = np.full((units, slots), S, np.int64)
    for u in range(units - 1):
        k = int(rng.integers(slots // 2, slots + 1))
        tab[u, :k] = u % groups * m2 + rng.choice(m2, k, replace=False)
    lift = _int_inf((groups + 1, m2, width), rng)
    clo = _int_inf((groups + 1, m2, m2), rng)
    lift[groups] = clo[groups] = np.inf
    unit = rng.integers(0, units, rows)
    row = _int_inf((rows, slots), rng)
    row[tab[unit] == S] = np.inf
    row[5::11] = np.inf
    dev = torch.device("cuda")
    f32 = lambda x: torch.from_numpy(x).to(dev)                # noqa: E731
    return {"row": f32(row), "unit": torch.from_numpy(unit).to(dev),
            "tab": torch.from_numpy(tab).to(dev, torch.int32),
            "gof": torch.from_numpy(gof).to(dev, torch.int32),
            "pof": torch.from_numpy(pof).to(dev, torch.int32),
            "lift": f32(lift), "clo": f32(clo)}


def _gather_work(op, q):
    """(lift cells, lift bytes, leg cells, leg bytes) these operands need:
    the (row, slot, column) cells whose terms are all finite (the leg's
    only for queries whose slot-0 groups agree, in one group), and each
    input byte once (rows, tables, the closure rows the units reach) with
    the outputs."""
    import torch
    row, unit, tab, gof, pof = (op[k] for k in ("row", "unit", "tab",
                                                "gof", "pof"))
    ids = tab.long()
    grp, pos = gof[ids].long(), pof[ids].long()
    m2 = op["clo"].shape[1]
    fin = torch.isfinite(row).double()
    lift = op["lift"].reshape(-1, op["lift"].shape[2])
    per_row = torch.isfinite(lift).double().sum(dim=1)
    rid = grp * m2 + pos                                     # [U, K]
    lift_cells = float((fin * per_row[rid[unit]]).sum())
    reached = torch.unique(rid[torch.unique(unit)])
    table = 4.0 * (tab.numel() + gof.numel() + pof.numel() + unit.numel())
    lift_bytes = (4.0 * (row.numel() + row.shape[0] * lift.shape[1]
                         + reached.numel() * lift.shape[1]) + table)
    clo = torch.isfinite(op["clo"].reshape(-1, m2))
    us, ut = unit[:q], unit[q:]
    leg_cells = 0.0
    blocks = 0
    for a, b in torch.unique(torch.stack([us, ut]), dim=1).T.tolist():
        if grp[a, 0] != grp[b, 0]:
            continue
        blk = (clo[rid[a][:, None], pos[b][None, :]]
               & (grp[a][:, None] == grp[b][None, :])).double()
        sel = (us == a) & (ut == b)
        leg_cells += float(((fin[:q][sel] @ blk) * fin[q:][sel]).sum())
        blocks += blk.numel()
    leg_bytes = 4.0 * (row.numel() + q + blocks) + table
    return lift_cells, lift_bytes, leg_cells, leg_bytes


def _check_gather_minplus(out):
    """The hierarchy's lift and leg kernels (``ops.gather_minplus``,
    ``ops.gather_minplus_twoside``) against their plain versions at each
    of ``GATHER_LEVELS`` at q = 1,024 (2,048 rows a lift: both sides), and
    at q = 24 (one warp a row), array-equal, timed by CUDA events and
    device time beside the plain version."""
    import functools

    import torch
    from repro_torch.core.device_engine import _chunk
    from repro_torch.kernels import gather_minplus as gm
    from repro_torch.kernels import ops
    for label, units, groups, m2, slots, width in GATHER_LEVELS:
        for q in (1024, 24):
            op = _gather_level(units, groups, m2, slots, width, 2 * q,
                               seed=slots + q)
            row, unit, tab, gof, pof = (op[k] for k in (
                "row", "unit", "tab", "gof", "pof"))
            lift_cells, lift_bytes, leg_cells, leg_bytes = _gather_work(op, q)
            lift = functools.partial(ops.gather_minplus, row, unit, tab, pof,
                                     op["lift"], gof=gof)
            leg_args = (row[:q], unit[:q], row[q:], unit[q:], tab, gof, pof,
                        op["clo"])
            leg = functools.partial(ops.gather_minplus_twoside, *leg_args)
            for kernel, fn, plain, cells, nbytes, regime in (
                    ("gather_minplus_cuda", lift, functools.partial(
                        lift, chunk=_chunk(row, width), force="ref"),
                     lift_cells, lift_bytes,
                     gm.plan(2 * q, slots, units, units)),
                    ("gather_minplus_twoside_cuda", leg, functools.partial(
                        leg, chunk=_chunk(row[:q], slots), force="ref"),
                     leg_cells, leg_bytes,
                     gm.plan(q, slots, units, units * units))):
                got, want = fn(), plain()
                torch.cuda.synchronize()
                ok = torch.equal(got, want)
                bound, by = _bound_ms(nbytes, 2.0 * cells)
                _record(out, {
                    "case": f"{label} q={q}", "kernel": kernel,
                    "q": q, "slots": slots, "width": width, "units": units,
                    "regime": regime, "equal": ok,
                    "max_abs_err": _max_abs_err(got, want),
                    "ms": _time_ms(fn, 20), "device_ms": _device_ms(fn, 20),
                    "plain_ms": _time_ms(plain, 1),
                    "bound_ms": bound, "bound_by": by,
                    "bound_ops_ms": 2.0 * cells / FP32_OPS_PER_S * 1e3,
                    "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "finite_cells": cells, "bytes": nbytes}, ok)


def _finite_triples(a, b) -> float:
    """(i, k, j) triples of a (min,+) product whose two terms are both
    finite: the work this data needs (a +inf term cannot move a min)."""
    import torch
    fa = torch.isfinite(a).double().sum(dim=0)
    fb = torch.isfinite(b).double().sum(dim=1)
    return float((fa * fb).sum())


def _record(out, rec, ok):
    print(f"  {rec['case']}: {rec}")
    out.append(rec)
    if not ok:
        raise AssertionError(f"{rec['case']}: kernel != plain version")


def _check_fw_batch(cases, out):
    """(label, b, n, all_inf): kernel 3 (``fw_batch_cuda``: registers up
    to DIST_REG_MAX_N, the batched blocked schedule above) against the
    plain version, fresh and in place on the matrices as strided tiles
    of a larger tensor (as the blocked schedule runs its diagonal
    tiles)."""
    import functools

    import numpy as np
    import torch
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import ops
    for label, b, n, all_inf in cases:
        rng = np.random.default_rng(b * 7907 + n)
        d_np = _int_inf((b, n, n), rng)
        d_np[list(all_inf)] = np.inf
        d = torch.from_numpy(d_np).cuda()
        kern = functools.partial(fw.fw_batch_cuda, d)
        got = kern()
        want = ops.fw_batch(d, force="ref")
        ok = torch.equal(got, want)
        big = torch.full((b, n + 5, n + 7), 7.0, device="cuda")
        tile = big[:, 2:2 + n, 3:3 + n]
        tile.copy_(d)
        fw.fw_batch_cuda(tile, tile)
        rest = torch.ones_like(big, dtype=torch.bool)
        rest[:, 2:2 + n, 3:3 + n] = False
        ok = ok and torch.equal(tile, want) and bool(
            (big[rest] == 7.0).all())
        torch.cuda.synchronize()
        bound, by = _bound_ms(8.0 * b * n * n, 2.0 * b * n ** 3)
        plain_ms = _time_ms(lambda: ops.fw_batch(d, force="ref"), 2)
        variant = "reg" if n <= fw.DIST_REG_MAX_N else "blocked"
        _record(out, {
            "case": label, "kernel": "fw_batch_cuda", "b": b, "n": n,
            "variant": variant, "equal": ok,
            "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(kern, 10), "device_ms": _device_ms(kern, 10),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}, ok)


def _check_minplus(cases, out):
    """(label, m, k, n, accum[, opts]): minplus_accum (C_in = an
    independent matrix, or B itself as the blocked FW's phase 2 passes
    it) or minplus, against the plain version.  opts "neg": integers
    from [-50, 50) (+inf as usual); "cold": minplus timed over copies of
    B that together exceed the L2 (at least 5), one a call, as
    ``_check_label_merge`` does (``_cold_minplus``), beside the warm
    reading."""
    import functools

    import numpy as np
    import torch
    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels import ops
    for label, m, k, n, accum, *opts in cases:
        rng = np.random.default_rng(m * 31 + k * 7 + n)
        lo = -50 if "neg" in opts else 0

        def ints(shape, frac=0.2):
            x = rng.integers(lo, lo + 100, size=shape).astype(np.float32)
            x[rng.random(shape) < frac] = np.inf
            return torch.from_numpy(x).cuda()
        a, b = ints((m, k)), ints((k, n))
        c = b if accum == "alias" else ints((m, n), 0.5)
        extra = {}
        if accum:
            kern = functools.partial(mp.minplus_accum_cuda, c, a, b)
            plain = functools.partial(ops.minplus_accum, c, a, b,
                                      force="ref")
            nbytes = 4.0 * (m * k + k * n + 2 * m * n)
        else:
            kern = functools.partial(mp.minplus_cuda, a, b)
            plain = functools.partial(ops.minplus, a, b, force="ref")
            nbytes = 4.0 * (m * k + k * n + m * n)
            extra["route"] = list(mp.route(m, k, n))
        got, want = kern(), plain()
        torch.cuda.synchronize()
        triples = _finite_triples(a, b)
        bound, by = _bound_ms(nbytes, 2.0 * triples)
        ok = torch.equal(got, want)
        timed = kern
        if "cold" in opts:
            timed, copies = _cold_minplus(mp.minplus_cuda, a, b)
            extra.update(copies=copies, warm_device_ms=_device_ms(kern, 20))
        _record(out, {
            "case": label,
            "kernel": "minplus_accum_cuda" if accum else "minplus_cuda",
            "m": m, "k": k, "n": n, "equal": ok,
            "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(timed, 20), "device_ms": _device_ms(timed, 20),
            "plain_ms": _time_ms(plain, 2),
            "bound_ms": bound, "bound_by": by,
            "finite_triples": triples, **extra}, ok)


def _check_minplus_into(cases, out):
    """(label, np_, block, s, phase): the in-place entries on views of a
    padded [np_, np_] matrix (integers, ~20% +inf, its pivot tile
    [s, s + block) closed) as the blocked schedule calls them: "panels"
    (phase 2's row panel, C = B = D[K, :] with the pivot columns
    skipped, and column panel, C = A = D[:, K] with the pivot rows
    skipped, in one launch) through ``minplus_accum_panels_cuda``;
    "cross" (phase 3 on all of D, the band skipped), "row" and "col"
    (one panel each, its aliased operand a copy of it, as the in-place
    entry takes no panel alias) through ``minplus_accum_into_cuda``;
    against the plain versions on a copy
    of the same matrix.  The bound counts the written cells (C_in read,
    C written), the rows of A and columns of B they need, and their
    finite triples."""
    import numpy as np
    import torch
    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels import ops
    for label, np_, block, s, phase in cases:
        rng = np.random.default_rng(np_ + block + s)
        x = torch.from_numpy(_int_inf((np_, np_), rng)).cuda()
        e = s + block
        x[s:e, s:e] = ops.fw_batch(x[None, s:e, s:e], force="ref")[0]

        rows0, cols0 = x[s:e].clone(), x[:, s:e].clone()

        def jobs(p):
            dkk, row, col = p[s:e, s:e], p[s:e], p[:, s:e]
            return {"row": [(row, dkk, rows0, (0, 0), (s, e))],
                    "col": [(col, cols0, dkk, (s, e), (0, 0))],
                    "cross": [(p, col, row, (s, e), (s, e))],
                    "panels": [(row, dkk, row, (0, 0), (s, e)),
                               (col, col, dkk, (s, e), (0, 0))]}[phase]

        def run(p, force=None):
            js = jobs(p)
            if phase == "panels":
                (rc, ra, rb, _, skip_c), (qc, qa, qb, skip_r, _) = js
                if force:
                    ops.minplus_accum_panels((rc, ra, rb), (qc, qa, qb),
                                             skip_cols=skip_c,
                                             skip_rows=skip_r, force=force)
                else:
                    mp.minplus_accum_panels_cuda((rc, ra, rb), (qc, qa, qb),
                                                 skip_cols=skip_c,
                                                 skip_rows=skip_r)
                return
            c, a, b, skip_r, skip_c = js[0]
            if force:
                ops.minplus_accum_into(c, a, b, skip_rows=skip_r,
                                       skip_cols=skip_c, force=force)
            else:
                mp.minplus_accum_into_cuda(c, a, b, skip_rows=skip_r,
                                           skip_cols=skip_c)
        got, want = x.clone(), x.clone()
        run(got)
        run(want, "ref")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        nbytes = triples = 0.0
        for c, a, b, skip_r, skip_c in jobs(x):
            m, n = c.shape
            live_r = torch.ones(m, dtype=torch.bool, device="cuda")
            live_r[skip_r[0]:skip_r[1]] = False
            live_c = torch.ones(n, dtype=torch.bool, device="cuda")
            live_c[skip_c[0]:skip_c[1]] = False
            a_w, b_w = a[live_r], b[:, live_c]
            nbytes += 4.0 * (2 * a_w.shape[0] * b_w.shape[1] + a_w.numel()
                             + b_w.numel())
            triples += _finite_triples(a_w, b_w)
        bound, by = _bound_ms(nbytes, 2.0 * triples)
        kernel = ("minplus_accum_panels_cuda" if phase == "panels"
                  else "minplus_accum_into_cuda")
        _record(out, {
            "case": label, "kernel": kernel, "np": np_, "block": block,
            "s": s, "phase": phase, "equal": ok,
            "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(lambda: run(got), 20),
            "device_ms": _device_ms(lambda: run(got), 20),
            "plain_ms": _time_ms(lambda: run(want, "ref"), 2),
            "bound_ms": bound, "bound_by": by, "finite_triples": triples},
            ok)


def _check_fw_apsp(cases, out):
    """The whole blocked schedule (ops.fw_apsp on the card: kernels
    fw_batch and minplus_accum_into) against the plain fw_ref, timed by
    CUDA events and by the profiler's device time."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.floyd_warshall import apsp_block
    for label, n, block, inf_frac in cases:
        rng = np.random.default_rng(n)
        d = torch.from_numpy(_int_inf((n, n), rng, inf_frac)).cuda()
        block = block or apsp_block(n)
        got = ops.fw_apsp(d, block=block)
        want = ops.fw_apsp(d, force="ref")
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        bound, by = _bound_ms(8.0 * n * n, 2.0 * n ** 3)
        big = n > 2000
        _record(out, {
            "case": label, "kernel": "ops.fw_apsp (fw_blocked)", "n": n,
            "block": block, "equal": ok,
            "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(lambda: ops.fw_apsp(d, block=block),
                           2 if big else 5),
            "device_ms": _device_ms(lambda: ops.fw_apsp(d, block=block),
                                    1 if big else 3),
            "plain_ms": _time_ms(lambda: ops.fw_apsp(d, force="ref"), 1),
            "bound_ms": bound, "bound_by": by}, ok)


#: every kernel entry: (name, wrapper module, wrapper attribute)
KERNELS = (("fw_next_reg", "floyd_warshall", "fw_next_reg_cuda"),
           ("fw_next_blocked", "floyd_warshall", "fw_next_blocked_cuda"),
           ("minplus_twoside_grouped", "minplus_twoside",
            "minplus_twoside_grouped_cuda"),
           ("fw_batch", "floyd_warshall", "fw_batch_cuda"),
           ("fw_dist_blocked", "floyd_warshall", "fw_dist_blocked_cuda"),
           ("minplus_accum", "minplus", "minplus_accum_cuda"),
           ("minplus_accum_into", "minplus", "minplus_accum_into_cuda"),
           ("minplus_accum_panels", "minplus", "minplus_accum_panels_cuda"),
           ("minplus", "minplus", "minplus_cuda"),
           ("minplus_twoside_argmin", "minplus_twoside",
            "minplus_twoside_argmin_cuda"),
           ("label_merge", "label_merge", "label_merge_cuda"),
           ("label_merge_rows", "label_merge", "label_merge_rows_cuda"),
           ("gather_minplus", "gather_minplus", "gather_minplus_cuda"),
           ("gather_minplus_twoside", "gather_minplus",
            "gather_minplus_twoside_cuda"))


#: kernel entries the main paths must not launch: the fresh-output
#: ``minplus_accum`` (the tests and the dry run's op table call it) and
#: the dense label merge (left when ``serve_hub`` took the row ids)
OFF_MAIN_PATH = ("minplus_accum", "label_merge")


def _wrapper(module: str, attr: str):
    import importlib
    return getattr(importlib.import_module(
        f"repro_torch.kernels.{module}"), attr)


def _reset_counts():
    for _name, module, attr in KERNELS:
        _wrapper(module, attr).launches = 0


def _read_counts() -> dict:
    return {name: _wrapper(module, attr).launches
            for name, module, attr in KERNELS}


@contextlib.contextmanager
def _uncounted():
    """Launches inside are timing runs, not the path's: every counter is
    put back as it was on the way out."""
    saved = _read_counts()
    try:
        yield
    finally:
        for name, module, attr in KERNELS:
            _wrapper(module, attr).launches = saved[name]


def _differ(a: dict, b: dict) -> list:
    """Names whose values differ between two convert.device_index_to_numpy
    dicts: arrays, per-level lists of arrays, and SlotMap sidecars."""
    import numpy as np

    def same(x, y):
        if isinstance(x, list):
            return (isinstance(y, list) and len(x) == len(y)
                    and all(same(p, q) for p, q in zip(x, y)))
        if hasattr(x, "keys") and hasattr(x, "slots"):        # SlotMap
            return (x.stride == y.stride
                    and np.array_equal(x.keys, y.keys)
                    and np.array_equal(x.slots, y.slots))
        return np.array_equal(x, y)
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not same(a[k], b[k]))


def _small_reference() -> dict:
    """road_like(900) with 96 seeded hub nodes on the card == the same
    build and serve on the CPU (plain versions), densely and at
    hierarchy levels 2 and 3: every field (per-level tables, hub tables
    and sidecars included), every answer (== Dijkstra), every witness
    (the CPU in the scatter layout, the card's), 64 card witnesses
    unwound to exact paths, and the hub answers on gated pairs
    (== query == Dijkstra); one-to-all too on the hierarchical
    builds."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import (build_device_index_with_plan,
                                                refresh_index,
                                                serve_one_to_all)
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.graph import road_like, traffic_updates
    from repro_torch.core.paths import PathUnwinder, path_weight
    from repro_torch.core.supergraph import build_index
    g = road_like(900, seed=0)
    ix = build_index(g)
    rng = np.random.default_rng(7)
    s, t = rng.integers(0, g.n, 256), rng.integers(0, g.n, 256)
    hubs = rng.choice(g.n, 96, replace=False)
    hs, ht = rng.integers(0, g.n, 4096), rng.integers(0, g.n, 4096)
    oracle = np.array([dijkstra.pair(g, int(x), int(y))
                       for x, y in zip(s[:64], t[:64])], np.float32)
    # one refresh epoch: a mixed batch of 3% of the edges
    u, v, w = traffic_updates(g, 0.03, seed=4)
    g2 = g.with_edge_weights(u, v, w)
    oracle2 = np.array([dijkstra.pair(g2, int(x), int(y))
                        for x, y in zip(s[:64], t[:64])], np.float32)
    out = {}
    for lv in (1, 2, 3):
        on_card, plan = build_device_index_with_plan(
            ix, device="cuda", hierarchy_levels=lv, hub_nodes=hubs)
        on_cpu, cpu_plan = build_device_index_with_plan(
            ix, device="cpu", hierarchy_levels=lv, hub_nodes=hubs)
        bad = _differ(convert.device_index_to_numpy(on_card),
                      convert.device_index_to_numpy(on_cpu))
        card, cpu = QueryPlanner(on_card), QueryPlanner(on_cpu,
                                                        layout="scatter")
        got = card.query(s, t)
        want = cpu.query(s, t)
        wd, ww = card.query_witness(s, t)
        cd, cw = cpu.query_witness(s, t)
        uw = PathUnwinder(on_card, plan)
        bad_paths = 0
        for i in range(64):
            path = uw.unwind(int(s[i]), int(t[i]), wd[i], int(ww[i]))
            bad_paths += not (path is not None and path[0] == s[i]
                              and path[-1] == t[i]
                              and path_weight(g, path) == float(wd[i])
                              == oracle[i])
        mask = card.hub_mask(hs, ht)
        # the gate admits nothing where one TOP group holds every
        # fragment (no route must touch the top boundary)
        top_groups = (0 if on_card.host_topgrp_frag is None
                      else np.unique(on_card.host_topgrp_frag).size)
        hub = card.query_hub(hs[mask], ht[mask])
        hub_oracle = np.array([dijkstra.pair(g, int(x), int(y)) for x, y
                               in zip(hs[mask][:32], ht[mask][:32])],
                              np.float32)
        res = {"levels_built": on_card.hierarchy_levels,
               "fields_differ": bad,
               "answers_equal": bool(np.array_equal(got, want)),
               "dijkstra_equal": bool(np.array_equal(got[:64], oracle)),
               "witness_dist_equal": bool(np.array_equal(wd, cd)
                                          and np.array_equal(wd, got)),
               "witnesses_equal": bool(np.array_equal(ww, cw)),
               "paths_exact": bad_paths == 0,
               "hub_gated": int(mask.sum()), "top_groups": top_groups,
               "hub_equal": bool((mask.any() or top_groups == 1)
                                 and np.array_equal(
                   hub, card.query(hs[mask], ht[mask]))
                   and np.array_equal(hub, cpu.query_hub(hs[mask],
                                                         ht[mask]))
                   and np.array_equal(hub[:32], hub_oracle))}
        if lv > 1:
            o2a = serve_one_to_all(on_card, 5).cpu().numpy()
            res["one_to_all_equal"] = bool(
                np.array_equal(o2a, serve_one_to_all(on_cpu, 5).numpy())
                and np.array_equal(o2a, dijkstra.sssp(g, 5).astype(
                    np.float32)))
        card2, card_st = refresh_index(on_card, plan, g2, u, v, w)
        cpu2, cpu_st = refresh_index(on_cpu, cpu_plan, g2, u, v, w)
        bad2 = _differ(convert.device_index_to_numpy(card2),
                       convert.device_index_to_numpy(cpu2))
        got2 = QueryPlanner(card2).query(s[:64], t[:64])
        res.update({
            "refresh_fields_differ": bad2,
            "refresh_top_closure": card_st.top_closure,
            "refresh_stats_equal": all(
                getattr(card_st, k) == getattr(cpu_st, k) for k in (
                    "n_dirty_frags", "n_dirty_pieces", "n_eb_slots",
                    "top_closure", "total_increase")),
            "refresh_answers_equal": bool(
                np.array_equal(got2, QueryPlanner(cpu2, layout="scatter")
                               .query(s[:64], t[:64]))
                and np.array_equal(got2, oracle2))})
        print(f"  road_like(900) levels={lv} card vs cpu: {res}")
        out[f"levels_{lv}"] = res
        if bad or bad2 or not all(
                v for k, v in res.items()
                if k not in ("fields_differ", "levels_built", "hub_gated",
                             "top_groups", "refresh_fields_differ",
                             "refresh_top_closure")):
            raise AssertionError(f"card and CPU builds disagree: {res}")
    return out


def _hub_check(g, dix, hubs, seed: int = 5) -> dict:
    """From 4,096 random candidate pairs of hub nodes (the endpoints the
    hub set was chosen for: a deployment pins its most frequent ones):
    the hub gate must admit some pairs, ``query_hub`` must equal the
    planner's ``query`` on every admitted pair and Dijkstra on 32 of
    them; times both on the gated pairs (host clock), then one
    ``serve_hub`` call on them as ``query_hub`` pads them (device time:
    every kernel it launches; CUDA events) and its label merge on the
    index's own table (``_merge_rows_times``), uncounted."""
    import functools

    import numpy as np
    import torch
    from repro_torch.core import dijkstra, padding
    from repro_torch.core.device_engine import serve_hub
    from repro_torch.core.dist_engine import QueryPlanner
    rng = np.random.default_rng(seed)
    s, t = rng.choice(hubs, 4096), rng.choice(hubs, 4096)
    planner = QueryPlanner(dix)
    mask = planner.hub_mask(s, t)
    s, t = s[mask], t[mask]
    got = planner.query_hub(s, t)
    want = planner.query(s, t)
    oracle = np.array([dijkstra.pair(g, int(a), int(b))
                       for a, b in zip(s[:32], t[:32])], np.float32)
    times = {}
    for name, fn in (("hub", planner.query_hub), ("planner", planner.query),
                     ("hub_again", planner.query_hub)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(s, t)                         # ends in a host copy
        times[name] = time.perf_counter() - t0
    res = {"candidates": 4096, "gated": int(mask.sum()),
           "labels": int(dix.hub_rows.shape[0]) - 1,
           "hub_equal_planner": bool(np.array_equal(got, want)),
           "hub_equal_dijkstra": bool(np.array_equal(got[:32], oracle)),
           "hub_us_per_query": [times[k] / max(1, s.size) * 1e6
                                for k in ("hub", "hub_again")],
           "planner_us_per_query": times["planner"] / max(1, s.size) * 1e6}
    if s.size:
        m = int(padding.pad_pow2(s.size))
        sp, tp = (torch.zeros(m, dtype=torch.int64, device="cuda")
                  for _ in range(2))
        sp[:s.size], tp[:s.size] = torch.from_numpy(s), torch.from_numpy(t)
        call = functools.partial(serve_hub, dix, sp, tp)
        with _uncounted():
            res["serve_hub"] = {
                "q": m, "device_ms": _device_ms(call, 20),
                "ms": _time_ms(call, 20),
                "merge": _merge_rows_times(
                    dix.hub_rows, dix.hub_of_agent[dix.agent_of[sp].long()],
                    dix.hub_of_agent[dix.agent_of[tp].long()])}
    print(f"  hub tier: {res}")
    if not (mask.any() and res["hub_equal_planner"]
            and res["hub_equal_dijkstra"]):
        raise AssertionError(f"hub tier: {res}")
    return res


def _main_path(graph: str, validate: int, sources=(), path_args=(),
               n_hubs: int = 0, json_out: bool = False) -> dict:
    """The main path through the serve CLI's entry points (build, then
    warmup + batches + validation, then the ``--paths`` loop; with
    ``json_out`` its records appended by ``--json`` to a temporary
    history and read back), then
    ``serve_one_to_all`` from ``sources`` against Dijkstra and, with
    ``n_hubs`` seeded random hub nodes, the hub tier (``_hub_check``);
    kernel launches counted in between.  After the count, each
    one-to-all source is timed on its own (``_one_to_all_ms``)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import perflog
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import serve_one_to_all
    from repro_torch.launch import serve
    tmp = tempfile.TemporaryDirectory()
    json_args = ("--json", f"{tmp.name}/serve.json") if json_out else ()
    args = serve.parse_args(["--graph", graph, "--batches", "5",
                             "--batch-size", "1024", "--validate",
                             str(validate), "--device", "cuda", "--paths",
                             *path_args, *json_args])
    g, ix = serve.build_host(args)
    hubs = (np.random.default_rng(11).choice(g.n, n_hubs, replace=False)
            if n_hubs else None)
    _reset_counts()
    try:
        g, dix, plan, summary = serve.build(args, hub_nodes=hubs,
                                            host=(g, ix))
    except SystemExit as e:            # a scale gate refused the build
        raise AssertionError(f"{graph}: {e}") from None
    _BUILT[graph] = (g, dix)
    _HOST[graph] = (ix, plan, hubs)
    # peak device memory of the build (reset in serve.build), then of
    # serving alone (the index held): serve() reads it as peak_device_mb
    peak_build_mb = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    res = serve.serve(args, g, dix, summary, plan)
    res["peak_build_mb"] = peak_build_mb
    print(f"  {graph} peak device memory: build {peak_build_mb:.1f} MiB, "
          f"serving {res['peak_device_mb']:.1f} MiB")
    if args.json:
        wrote = serve.write_records(args.json, serve.records(args, res))
        back = perflog.read_records(args.json)
        tmp.cleanup()
        res["json_sections"] = [r["section"] for r in back]
        if back != json.loads(json.dumps(wrote, default=str)) or res[
                "json_sections"] != ["host_build", "serve", "serve_paths"]:
            raise AssertionError(f"{graph} --json: read back "
                                 f"{res['json_sections']}")
    if n_hubs:
        res["hub"] = _hub_check(g, dix, hubs)
    bad_o2a = 0
    for src in sources:
        got = serve_one_to_all(dix, int(src)).cpu().numpy()
        want = dijkstra.sssp(g, int(src)).astype(np.float32)
        bad_o2a += int((got != want).sum())
    res["launches"] = _read_counts()
    if sources:
        res["one_to_all"] = {"sources": [int(x) for x in sources],
                             "mismatches": bad_o2a,
                             **_one_to_all_ms(dix, sources)}
        print(f"  {graph} one-to-all from {list(sources)}: {bad_o2a} "
              f"mismatches against Dijkstra; per source "
              f"{res['one_to_all']}")
    print(f"  {graph} launches: {res['launches']}")
    if (res["mismatches"] or res["paths"]["mismatches"]
            or not res["answers_finite"] or bad_o2a):
        raise AssertionError(f"{graph}: {res['mismatches']} mismatches, "
                             f"{res['paths']['mismatches']} path "
                             f"mismatches, answers finite: "
                             f"{res['answers_finite']}, one-to-all "
                             f"mismatches: {bad_o2a}")
    return res


def _one_to_all_ms(dix, sources, reps: int = 5) -> dict:
    """``serve_one_to_all`` timed a source on its own, warm: the median
    host-clock ms of ``reps`` calls each ending in a synchronise, and the
    device ms a call (every kernel it launches, ``_device_ms``)."""
    import functools
    import statistics

    import torch
    from repro_torch.core.device_engine import serve_one_to_all
    ms, dev = [], []
    for src in sources:
        call = functools.partial(serve_one_to_all, dix, int(src))
        call()
        torch.cuda.synchronize()
        took = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            took.append((time.perf_counter() - t0) * 1e3)
        ms.append(statistics.median(took))
        dev.append(_device_ms(call, 3))
    return {"ms_per_source": ms, "device_ms_per_source": dev}


def _require_launched(res: dict, graph: str, names) -> None:
    zero = [k for k in names if res["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"{graph}: kernels never launched: {zero}")


def _level_differential() -> dict:
    """road4000 at hierarchy levels 1, 2 and 3 on the card: 1,024
    array-equal answers (and the built depths)."""
    import numpy as np
    from repro_torch.core.device_engine import build_device_index
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.graph import road_like
    from repro_torch.core.supergraph import build_index
    g = road_like(4000, seed=0)
    ix = build_index(g)
    rng = np.random.default_rng(2)
    s, t = rng.integers(0, g.n, 1024), rng.integers(0, g.n, 1024)
    base, res = None, {}
    for lv in (1, 2, 3):
        dix = build_device_index(ix, device="cuda", hierarchy_levels=lv)
        out = QueryPlanner(dix).query(s, t)
        res[f"levels_{lv}"] = {"built": dix.hierarchy_levels,
                               "finite": bool(np.isfinite(out).all())}
        if base is None:
            base = out
        elif not np.array_equal(base, out):
            raise AssertionError(f"road4000 levels={lv} differs from "
                                 f"levels=1 on "
                                 f"{int((base != out).sum())} answers")
    print(f"  road4000 levels 1/2/3: 1024 answers array-equal; {res}")
    return res


def _count_refreshes(record: list, stats: list | None = None):
    """Make every ``refresh_index`` call an ``EpochedEngine`` makes
    append its kernel launches (the counters' difference across the
    call) to ``record``, and its ``RefreshStats`` record to ``stats``;
    returns the function that undoes it."""
    from repro_torch.core import dist_engine
    inner = dist_engine.refresh_index

    def counted(*args, **kwargs):
        before = _read_counts()
        out = inner(*args, **kwargs)
        after = _read_counts()
        record.append({k: after[k] - before[k] for k in after})
        if stats is not None:
            stats.append(out[1].as_record())
        return out
    dist_engine.refresh_index = counted
    return lambda: setattr(dist_engine, "refresh_index", inner)


def _scratch_equal(engine_dix, g, ix, plan, hubs) -> tuple[list, float]:
    """(fields and sidecars that differ, seconds) of the scratch rebuild
    ``build_device_index(reweight_index(ix, g))`` on the card with the
    live plan's depth, resident budget and hub set."""
    import torch
    from repro_torch.core.device_engine import (build_device_index,
                                                index_fields_equal,
                                                sidecars_equal)
    from repro_torch.core.supergraph import reweight_index
    from repro_torch.launch.serve import REFRESHED_FIELDS
    t0 = time.perf_counter()
    sdix = build_device_index(reweight_index(ix, g), device="cuda",
                              hierarchy_levels=plan.hierarchy_levels,
                              resident_mb=plan.resident_mb, hub_nodes=hubs)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    eq = {**index_fields_equal(engine_dix, sdix, REFRESHED_FIELDS),
          **sidecars_equal(engine_dix, sdix)}
    return sorted(k for k, ok in eq.items() if not ok), took


def _pipeline_drain(engine, frac: float = 0.05, n_check: int = 32) -> dict:
    """One ``frac`` batch staged through a ``RefreshPipeline`` (at most 4
    work items, each published as an epoch): ``n_check`` answers ==
    Dijkstra on every epoch, and the final epoch == scratch."""
    import numpy as np
    from repro_torch.core import dijkstra
    from repro_torch.core.graph import traffic_updates
    from repro_torch.core.refresh_pipeline import RefreshPipeline
    u, v, w = traffic_updates(engine.g, frac, seed=77)
    pipe = RefreshPipeline(engine, max_items=4)
    pipe.submit(u, v, w)
    items = pipe.plan()
    rng = np.random.default_rng(8)
    epochs, bad = [], 0
    while True:
        st = pipe.step()
        if st is None:
            break
        s, t = rng.integers(0, engine.g.n, n_check), rng.integers(
            0, engine.g.n, n_check)
        got = engine.query(s, t)
        miss = sum(dijkstra.mismatches_oracle(
            dijkstra.pair(engine.g, int(a), int(b)), float(x))
            for a, b, x in zip(s, t, got))
        bad += miss
        epochs.append({"epoch": engine.epoch, "mismatches": miss,
                       "staleness": engine.snapshot()[3].as_record(),
                       **st.as_record()})
    plan = engine.plan
    differ, scratch_s = _scratch_equal(engine.dix, engine.g, engine.ix,
                                       plan, plan.hub_nodes)
    res = {"update_frac": frac, "updates": int(u.size), "items": items,
           "epochs": epochs, "mismatches": bad, "scratch_differ": differ,
           "scratch_reweight_s": scratch_s}
    print(f"  staged drain of {u.size} updates in {items} items: {bad} "
          f"mismatches over {len(epochs)} epochs x {n_check}; final "
          f"epoch == scratch: {not differ}; per item "
          f"{[(e['top_closure'], e['refresh_s']) for e in epochs]}")
    return res


def _road4000_refresh() -> dict:
    """road4000 (dense) through the serve CLI with ``--update-batches 3
    --update-frac 0.02``: every epoch refreshed on the card == its
    scratch rebuild (tables and sidecars), 64 answers == Dijkstra, and
    launches both witness FW kernels; on the last epoch a ``--paths``
    batch of 1,024 (64 validated); then a staged drain
    (``_pipeline_drain``)."""
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--graph", "road4000", "--batches", "2", "--batch-size", "1024",
        "--validate", "64", "--device", "cuda", "--update-batches", "3",
        "--update-frac", "0.02", "--paths", "--path-batches", "1",
        "--path-batch-size", "1024"])
    per_call: list = []
    undo = _count_refreshes(per_call)
    try:
        engine, res = serve.run_epoched(args)
        rounds = per_call[-args.update_batches:]
        res["drain"] = _pipeline_drain(engine)
    finally:
        undo()
    for rec, launches in zip(res["refresh"], rounds):
        rec["launches"] = launches
    res["launches"] = {k: sum(r[k] for r in rounds) for k in rounds[0]}
    print(f"  road4000 refresh launches per epoch: {rounds}")
    checks = {
        "no_mismatch": serve.failures(res) == 0,
        "all_validated": all(r["validated"] == 64 for r in res["refresh"])
        and res["paths_last_epoch"]["validated"] == 64,
        "fw_kernels_each_epoch": all(
            r["fw_next_blocked"] > 0 and r["fw_next_reg"] > 0
            for r in rounds),
        "drain_exact": res["drain"]["mismatches"] == 0
        and not res["drain"]["scratch_differ"],
    }
    res["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"road4000 refresh: {checks}")
    return res


def _refresh_epoch(g, dix, ix, plan, hubs, frac: float, jam: float,
                   seed: int, n_check: int, rng) -> tuple:
    """One ``refresh_index`` epoch on the card (``traffic_updates(g,
    frac, seed=seed, jam_frac=jam)``), launch counters zeroed just
    before and read just after, with the tracer on: the epoch against
    its scratch reweight rebuild with the same hub set, and ``n_check``
    random answers against Dijkstra on the new weights.  Returns (the
    record, the new graph, the new index)."""
    import torch
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import refresh_index
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.graph import traffic_updates
    from repro_torch.obs import trace
    tracer = trace.get_tracer()
    u, v, w = traffic_updates(g, frac, seed=seed, jam_frac=jam)
    w_old = g.edge_w[g.edge_ids(u, v)]
    g2 = g.with_edge_weights(u, v, w)
    torch.cuda.synchronize()
    _reset_counts()
    tracer.clear()
    tracer.enable()
    t0 = time.perf_counter()
    dix2, stats = refresh_index(dix, plan, g2, u, v, w, w_old=w_old)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    tracer.enable(False)
    launches = _read_counts()
    # seconds of the spans inside the stages (the top closure's FW and
    # first_hops, the dirty groups' FW, the resident re-lift)
    spans: dict = {}
    for ev in tracer.drain():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e6
    differ, scratch_s = _scratch_equal(dix2, g2, ix, plan, hubs)
    s, t = rng.integers(0, g2.n, n_check), rng.integers(0, g2.n, n_check)
    got = QueryPlanner(dix2).query(s, t)
    bad = sum(dijkstra.mismatches_oracle(
        dijkstra.pair(g2, int(a), int(b)), float(x))
        for a, b, x in zip(s, t, got))
    rec = {"update_frac": frac, "jam_frac": jam, "updates": int(u.size),
           "refresh_wall_s": refresh_s, **stats.as_record(),
           "stage_s": dict(stats.timings), "spans_s": spans,
           "n_eb_slots": stats.n_eb_slots,
           "scratch_reweight_s": scratch_s, "scratch_differ": differ,
           "checked": int(n_check), "mismatches": bad,
           "launches": launches}
    return rec, g2, dix2


def _road64k_refresh() -> dict:
    """Two refresh epochs on phase 6's road64k index (no second build),
    through ``refresh_index`` directly (``_refresh_epoch``): a
    decrease-only batch (``traffic_updates(frac=0.001, jam_frac=0)``),
    then a jam (``frac=0.005, jam_frac=1``).  Each epoch == the scratch
    reweight rebuild with the same hub set, 32 answers == Dijkstra, hub
    answers on gated pairs == ``query`` (``_hub_check``), one one-to-all
    source == Dijkstra."""
    import numpy as np
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import serve_one_to_all
    g, dix = _BUILT["road64k"]
    ix, plan, hubs = _HOST["road64k"]
    rng = np.random.default_rng(12)
    out = []
    for label, frac, jam in (("decrease", 0.001, 0.0), ("jam", 0.005, 1.0)):
        rec, g2, dix2 = _refresh_epoch(g, dix, ix, plan, hubs, frac, jam,
                                       10, 32, rng)
        hub = _hub_check(g2, dix2, hubs)
        src = g2.n // 2
        o2a = serve_one_to_all(dix2, src).cpu().numpy()
        bad_o2a = int((o2a != dijkstra.sssp(g2, src).astype(
            np.float32)).sum())
        rec = {"batch": label, **rec, "one_to_all_mismatches": bad_o2a,
               "hub_gated": hub["gated"]}
        print(f"  road64k {label} epoch: top_closure "
              f"{rec['top_closure']}, stages {rec['stage_s']}; spans "
              f"{ {k: round(x, 4) for k, x in rec['spans_s'].items()} }; "
              f"scratch reweight rebuild {rec['scratch_reweight_s']:.2f}s,"
              f" match={not rec['scratch_differ']}; {rec['mismatches']} "
              f"mismatches of 32; one-to-all {bad_o2a}; launches "
              f"{rec['launches']}")
        out.append(rec)
        g, dix = g2, dix2
    need = {"decrease": ("fw_next_blocked", "fw_next_reg"),
            "jam": ("fw_next_blocked", "fw_next_reg", "fw_batch",
                    "minplus_accum_panels", "minplus_accum_into")}
    checks = {
        "exact": all(not r["scratch_differ"] and r["mismatches"] == 0
                     and r["one_to_all_mismatches"] == 0 for r in out),
        "jam_full_fw": out[1]["top_closure"] == "full_fw",
        "launched": all(r["launches"][k] > 0 for r in out
                        for k in need[r["batch"]])}
    res = {"epochs": out, "checks": checks,
           "launches": {k: sum(r["launches"][k] for r in out)
                        for k in out[0]["launches"]}}
    if not all(checks.values()):
        raise AssertionError(f"road64k refresh: {checks}")
    return res


def _first_hops_check(graph: str, n_rows: int = 128) -> dict:
    """The top closure's witnesses of the index built for ``graph``
    (before any refresh moves its plan's weights): ``hierarchy.first_hops``
    on the card (plain torch, no kernel) array-equal to the same function
    on CPU copies of the inputs on ``n_rows`` seeded rows, and the card's
    full table (timed with CUDA events) == the built ``d2_next``."""
    import numpy as np
    import torch
    from repro_torch.core import hierarchy
    _g, dix = _BUILT[graph]
    plan = _HOST[graph][1]
    h = plan.hier[-1]
    n = h.S2
    adj = hierarchy.to_device(hierarchy.l2_overlay(h), dix.device)
    d = dix.d2[:n, :n]
    rows = np.sort(np.random.default_rng(3).choice(n, min(n_rows, n),
                                                   replace=False))
    got = hierarchy.first_hops(adj, d, rows=rows).cpu()
    t0 = time.perf_counter()
    want = hierarchy.first_hops(adj.cpu(), d.cpu(), rows=rows)
    cpu_rows_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    full = hierarchy.first_hops(adj, d)
    end.record()
    end.synchronize()
    res = {"n": int(n), "rows": int(rows.size),
           "rows_equal_cpu": bool(torch.equal(got, want)),
           "full_equal_d2_next": bool(torch.equal(full,
                                                  dix.d2_next[:n, :n])),
           "full_ms": start.elapsed_time(end),
           "cpu_rows_s": cpu_rows_s,
           "build_s": plan.build_timings.get("first_hops")}
    print(f"  {graph} first_hops on the card: {res}")
    if not (res["rows_equal_cpu"] and res["full_equal_d2_next"]):
        raise AssertionError(f"{graph} first_hops: {res}")
    return res


def _reference_record(graph: str) -> dict:
    """The reference's ``exp10_scale`` record of ``graph`` in the
    repository's ``BENCH_serve.json``."""
    recs = json.loads((ROOT / "BENCH_serve.json").read_text())
    return next(r for r in recs if r.get("section") == "exp10_scale"
                and r.get("graph") == graph)


#: the shape columns of road250k's build held equal to the reference's
#: record (``_reference_record``)
SHAPE_KEYS = ("n", "S", "hierarchy_levels", "nsf", "S2", "overlay_bytes",
              "overlay_dense_bytes")


def _road250k() -> dict:
    """road250k (the preset's ``"auto"`` hierarchy, 5 levels) through
    the serve CLI's entry points (``_main_path``: ``--expect-hierarchy
    5``, a host build on every core, 32 validated, ``--paths`` at one
    batch of 4, one-to-all from 2 sources, 2,048 hub nodes); its shapes
    == the reference's record; the top witnesses on the card ==
    the CPU's (``_first_hops_check``); then one 1% traffic epoch
    (``_refresh_epoch``), 16 answers == Dijkstra before and after it and
    == its scratch rebuild.  Between the two, kernels 1 and 2 timed on
    its own tables (``_road250k_kernels``)."""
    import os

    import numpy as np
    from repro_torch.core import dijkstra
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.hierarchy import hier_overlay_stats
    workers = max(2, os.cpu_count() or 2)
    try:
        res = _main_path(
            "road250k", 32, sources=(0, 120_000),
            path_args=("--path-batches", "1", "--path-batch-size", "4",
                       "--expect-hierarchy", "5", "--build-workers",
                       str(workers)),
            n_hubs=2048)
        g, dix = _BUILT["road250k"]
        ix, plan, hubs = _HOST["road250k"]
        st = hier_overlay_stats(plan.hier, plan.S)
        shapes = {"n": g.n, **{k: st[k] for k in SHAPE_KEYS[1:]}}
        want = {k: _reference_record("road250k")[k] for k in SHAPE_KEYS}
        res["shapes"] = shapes
        res["levels"] = [
            {"level": li + 1, "nsf": h.nsf, "m2": h.m2, "S2": h.S2,
             "sf_closure": list(dix.sf_closure[li].shape)}
            for li, h in enumerate(plan.hier)]
        res["top"] = list(dix.d2.shape)
        print(f"  road250k shapes {shapes} (reference {want}); per level "
              f"{res['levels']}; top {res['top']}")
        if shapes != want:
            raise AssertionError(f"road250k shapes {shapes} != the "
                                 f"reference's {want}")
        res["first_hops"] = _first_hops_check("road250k")
        res["kernel_times"] = _road250k_kernels(g, dix, plan)
        rng = np.random.default_rng(13)
        s, t = rng.integers(0, g.n, 16), rng.integers(0, g.n, 16)
        before = sum(dijkstra.mismatches_oracle(
            dijkstra.pair(g, int(a), int(b)), float(x))
            for a, b, x in zip(s, t, QueryPlanner(dix).query(s, t)))
        # the 1% batch of Exp-10 (``traffic_updates(g, 0.01, seed=11)``)
        rec, _g2, _dix2 = _refresh_epoch(g, dix, ix, plan, hubs, 0.01,
                                         0.5, 11, 16, rng)
        rec["mismatches_before"] = before
        res["refresh"] = rec
        print(f"  road250k 1% epoch ({rec['updates']} updates): top_closure"
              f" {rec['top_closure']}, refresh {rec['refresh_wall_s']:.2f}s,"
              f" stages {rec['stage_s']}; spans "
              f"{ {k: round(x, 4) for k, x in rec['spans_s'].items()} }; "
              f"scratch reweight rebuild {rec['scratch_reweight_s']:.2f}s, "
              f"match={not rec['scratch_differ']}; mismatches of 16 before "
              f"{before}, after {rec['mismatches']}; launches "
              f"{rec['launches']}")
        if before or rec["mismatches"] or rec["scratch_differ"]:
            raise AssertionError(f"road250k refresh: {rec}")
    finally:
        _BUILT.pop("road250k", None)
        _HOST.pop("road250k", None)
    return res


def _road250k_kernels(g, dix, plan) -> dict:
    """Kernels 1 and 2 timed on road250k's own tables (phase 7b's build
    plan and index; no second build), uncounted: the blocked witness FW
    (``ops.fw_batch_next``, CUDA events and device time) on the fragment
    batch and on the widest group batch at n = 2,048 and at 4,096, and
    the grouped twoside on the operands the planner hands it for a
    batch of 1,024 (``_check_twoside_grouped``: array-equal to its plain
    version).  Kernel 7 at W = 4,661 is timed by the hub check."""
    import functools

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    batches = [("fragments", plan.frag_adj)]
    for n in (2048, 4096):
        adjs = [h.sf_adj for h in plan.hier if h.sf_adj.shape[-1] == n]
        if adjs:
            batches.append((f"groups n={n}",
                            max(adjs, key=lambda a: a.shape[0])))
    res: dict = {"fw_next_blocked": [], "grouped": []}
    with _uncounted():
        for label, adj in batches:
            d = torch.from_numpy(np.ascontiguousarray(adj,
                                                      np.float32)).cuda()
            b, n = d.shape[0], d.shape[-1]
            fn = functools.partial(ops.fw_batch_next, d)
            bound, by = _bound_ms(12.0 * b * n * n, 2.0 * b * n ** 3)
            rec = {"case": f"road250k {label} [{b},{n},{n}]", "b": b,
                   "n": n, "ms": _time_ms(fn, 2),
                   "device_ms": _device_ms(fn, 2), "bound_ms": bound,
                   "bound_by": by}
            print(f"  {rec}")
            res["fw_next_blocked"].append(rec)
            del d, fn
            torch.cuda.empty_cache()
        calls = _capture_grouped(dix, g.n, 21)
        _check_twoside_grouped([(f"serve road250k {site}",
                                 args) for site, args in calls.items()],
                               res["grouped"])
    return res


#: kernels a refresh launches; serving launches none of them, so their
#: counts across a refresh call are the refresh's own even while a
#: serving thread launches its kernels beside it
REFRESH_KERNELS = ("fw_next_reg", "fw_next_blocked", "fw_batch",
                   "minplus_accum", "minplus_accum_into",
                   "minplus_accum_panels", "minplus")

#: road4000_live's bound on the longest stretch with no response while
#: three refresh rounds run beside serving (``--max-serving-gap``): 2.5x
#: the 202 ms the first card run measured (H100, 700 W), whose longest
#: stalls came with and without refresh alike
ROAD4000_MAX_GAP_S = 0.5

#: of road64k_live's 6,000 Zipf pairs, the hub gate admits this many
#: (computed from the host build on the CPU and pinned by
#: ``tests/test_torch_serving.py::test_road64k_live_hub_share_pinned``)
ROAD64K_LIVE_GATED = 3209


def _live(engine, args, refresh_stats: list | None = None) -> dict:
    """One ``serve.live_loop`` with the launch counters zeroed just
    before and read just after, and each refresh call's own launches
    and stats; fails on a mismatch, a failed gate, or a kernel library
    built or loaded during the run (everything was loaded before it),
    or no planner bucket replayed as a CUDA graph (``graphs``: buckets
    replayed, captured, run eagerly, and graphs captured, new epochs'
    included).  Records the process's full (generation-2)
    garbage collections during the run: each stops every thread, the
    flusher included."""
    import gc

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    libs, builds = set(_build._LIBS), []
    inner_build = _build.build
    _build.build = lambda *a, **k: builds.append(a) or inner_build(*a, **k)
    pauses, started = [], [0.0]

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                pauses.append((time.perf_counter() - started[0]) * 1e3)
    per_call: list = []
    undo = _count_refreshes(per_call, refresh_stats)
    gc.callbacks.append(on_gc)
    _reset_counts()
    graphs = engine.planner.graph_counts
    before = dict(graphs)
    try:
        live = serve.live_loop(engine, args)
    finally:
        gc.callbacks.remove(on_gc)
        undo()
        _build.build = inner_build
    live["gc_gen2_ms"] = pauses
    live["launches"] = _read_counts()
    live["refresh_launches"] = [{k: c[k] for k in REFRESH_KERNELS}
                                for c in per_call]
    # planner buckets replayed as CUDA graphs, captured first, or run
    # eagerly, and graphs captured (at warm-up and in each new epoch)
    live["graphs"] = {k: graphs[k] - before[k] for k in graphs}
    rec = live["serve_live"]
    if rec["oracle_bad"] or live["gate_failures"] or builds \
            or set(_build._LIBS) != libs or not live["graphs"]["replay"]:
        raise AssertionError(
            f"live at {rec['rate_qps']} qps: {rec['oracle_bad']} "
            f"mismatches, gates {live['gate_failures']}, builds {builds}, "
            f"libraries loaded {sorted(set(_build._LIBS) - libs)}, "
            f"planner graphs {live['graphs']}")
    return live


def _live_numbers(live: dict) -> dict:
    """The numbers PERF.md keeps of one live run (with the longest full
    garbage collection inside it)."""
    rec = live["serve_live"]
    return {"gc_gen2": len(live["gc_gen2_ms"]),
            "gc_gen2_max_ms": max(live["gc_gen2_ms"], default=0.0),
            "graphs": live["graphs"],
            **{k: rec.get(k) for k in (
        "rate_qps", "n_requests", "offered_qps", "achieved_qps", "p50_ms",
        "p95_ms", "p99_ms", "max_ms", "cache_hits", "label_hits",
        "planner_dispatches", "mean_occupancy", "flushes",
        "max_serving_gap_ms", "epochs_served", "oracle_checked",
        "label_us_per_query", "planner_us_per_query", "refresh_items",
        "refresh_mean_s", "refresh_max_s")}}


def _sum_launches(runs) -> dict:
    return {name: sum(r["launches"][name] for r in runs)
            for name, _m, _a in KERNELS}


def _road4000_live() -> dict:
    """``serve --nodes 4000 --live`` on the card: a parallel host build
    (4 spawned workers) held to the serial one, streamed into the device
    build; 3 s of Zipf traffic at 4,000 qps through the cache, the hub
    tier (256 nodes) and the planner while 3 refresh rounds run beside
    it on the refresh stream; 256 responses against the Dijkstra oracle
    of their epochs; metrics and a Chrome trace to ``chiprun_out/``.
    Then the same engine without refresh at 2,000, 8,000 and 32,000 qps
    offered, each run validated."""
    from repro_torch.launch import serve
    from repro_torch.obs import trace
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    base = ["--nodes", "4000", "--live", "--mix", "zipf", "--live-seconds",
            "3", "--hub-budget", "256", "--validate", "256",
            "--build-workers", "4", "--device", "cuda"]
    args = serve.parse_args(base + [
        "--rate", "4000", "--live-update-batches", "3", "--update-frac",
        "0.02", "--check-build-parity",
        "--max-serving-gap", str(ROAD4000_MAX_GAP_S),
        "--metrics-out", str(out_dir / "live_road4000_metrics.json"),
        "--trace-out", str(out_dir / "live_road4000_trace.json")])
    tracer = trace.get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        engine, res = serve.build_engine(args)
        stats: list = []
        res["live"] = _live(engine, args, stats)
    finally:
        tracer.enable(False)
    serve._write_trace(args)
    tracer.clear()
    live = res["live"]
    rec = live["serve_live"]
    res["refresh_stats"] = stats
    res["refresh_run"] = _live_numbers(live)
    print(f"  road4000 live refresh launches per epoch: "
          f"{live['refresh_launches']}")
    rates = {}
    for rate in (2000, 8000, 32000):
        rates[rate] = _live(engine, serve.parse_args(
            base + ["--rate", str(rate)]))
    res["rates"] = {r: _live_numbers(x) for r, x in rates.items()}
    sustained = [r for r, x in res["rates"].items()
                 if x["achieved_qps"] >= 0.95 * r]
    res["highest_sustained_qps"] = max(sustained, default=None)
    print(f"  road4000 live: {res['rates']}; highest rate with >= 95% "
          f"achieved: {res['highest_sustained_qps']}")
    res["launches"] = _sum_launches([live, *rates.values()])
    checks = {
        "build_parity": not res["build_parity"]["differ"],
        "epochs_served": rec["epochs_served"] > 1,
        "refresh_rounds": rec["refresh_rounds"] == 3,
        "fw_kernels_in_refresh": all(
            sum(c[k] for c in live["refresh_launches"]) > 0
            for k in ("fw_next_blocked", "fw_next_reg")),
        "serving_kernels": all(live["launches"][k] > 0 for k in (
            "label_merge_rows", "minplus_twoside_grouped")),
    }
    res["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"road4000 live: {checks}")
    return res


def _road64k_live() -> dict:
    """``serve --graph road64k --live`` on phase 6's host index (the
    preset's 3 levels, 2,048 hub nodes from the Zipf pool): 3 s at 2,000
    qps with the cache off, where the label tier must serve exactly the
    pairs the hub gate admits (``ROAD64K_LIVE_GATED``), then with the
    cache on, then 12 s beside one refresh round (0.1% of the edges, one
    epoch): its longest serving gap and the epoch's ``top_closure``
    are recorded, not bounded.  128
    responses of each run against the oracle of their epochs."""
    from repro_torch.data.queries import workload_pairs
    from repro_torch.launch import serve
    g = _BUILT["road64k"][0]
    ix = _HOST["road64k"][0]
    base = ["--graph", "road64k", "--live", "--mix", "zipf", "--rate",
            "2000", "--hub-budget", "2048", "--validate", "128",
            "--device", "cuda"]
    off = serve.parse_args(base + ["--live-seconds", "3",
                                   "--cache-size", "0"])
    engine, res = serve.build_engine(off, host=(g, ix))
    n = int(round(off.rate * off.live_seconds))
    pairs = workload_pairs(engine.g, off.mix, n, seed=off.seed + 4,
                           zipf_a=off.zipf_a)
    gated = int(engine.planner.hub_mask(pairs[:, 0], pairs[:, 1]).sum())
    runs = {"cache_off": _live(engine, off),
            "cache_on": _live(engine, serve.parse_args(
                base + ["--live-seconds", "3"]))}
    stats: list = []
    runs["refresh"] = _live(engine, serve.parse_args(base + [
        "--live-seconds", "12", "--live-update-batches", "1",
        "--update-frac", "0.001", "--no-live-pipelined"]), stats)
    res["runs"] = {k: _live_numbers(x) for k, x in runs.items()}
    res["refresh_stats"] = stats
    res["refresh_launches"] = runs["refresh"]["refresh_launches"]
    res["gated_pairs"] = gated
    res["launches"] = _sum_launches(runs.values())
    label = runs["cache_off"]["serve_live"]["label_hits"]
    print(f"  road64k live: {res['runs']}; cache off: label tier "
          f"{label} of {n}, hub gate admits {gated} (pinned "
          f"{ROAD64K_LIVE_GATED}); refresh {stats}")
    checks = {
        "label_share_is_gate_share": label == gated == ROAD64K_LIVE_GATED,
        "refresh_epoch_published": len(stats) == 1,
        "serving_kernels": all(runs["cache_off"]["launches"][k] > 0 for k in (
            "label_merge_rows", "minplus_twoside_grouped")),
    }
    res["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"road64k live: {checks}")
    return res


#: the bench gate's sections that the ``gate`` phase gates on the card:
#: each one's max/min over the committed history's 5 card runs stays
#: under the gate's 2.5x factor (``serve`` 1.64, ``host_build`` 1.09).
#: ``live`` (p99 3.39) is not; nor is ``refresh``, whose history passes
#: (1.75-2.31) but whose serving gap in this script's first card run was
#: 5.15x the history's median, as the live tail is (PERF.md §5 "Bench
#: gate"; ROADMAP queue 2 item 9)
GATED_SECTIONS = ("serve", "host_build")

#: the gate's sections in the order the phase runs them, each with its
#: flag of ``python -m repro_torch.launch.bench_gate``
GATE_SECTIONS = (("serve", ()), ("live", ("--live",)),
                 ("refresh", ("--refresh",)),
                 ("host_build", ("--host-build",)))


def _gate_run(flags, fresh: Path, history: Path | None = None) -> dict:
    """One ``python -m repro_torch.launch.bench_gate`` run (road4000,
    the gate's defaults) with its fresh records in ``fresh`` -> its exit
    code, its ``bench_gate:`` lines, its seconds and its fresh records."""
    import os

    from repro_torch.perflog import read_records
    fresh.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.bench_gate",
           "--fresh", str(fresh), *flags]
    if history is not None:
        cmd += ["--history", str(history)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("BENCH_GATE_FACTOR", None)      # the gate's own 2.5x
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    took = time.perf_counter() - t0
    lines = [x for x in proc.stdout.splitlines()
             if x.startswith("bench_gate:") and "running" not in x]
    for x in lines:
        print(f"  {x}")
    if proc.returncode not in (0, 1) or (
            proc.returncode and not any("FAIL —" in x for x in lines)):
        # the serve run or a field contract failed: not a gate verdict
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"bench_gate {list(flags)}: exit "
                             f"{proc.returncode} with no gate verdict")
    return {"rc": proc.returncode, "lines": lines, "s": took,
            "records": read_records(str(fresh))}


def _gate() -> dict:
    """``python -m repro_torch.launch.bench_gate`` on the card: its four
    sections at road4000 (``serve`` 3 batches of 1,024; ``--live`` and
    ``--refresh`` Zipf at 500 qps for 3 s beside one refresh round;
    ``--host-build`` 2 workers) against the committed
    ``BENCH_torch_serve.json``.  A section of ``GATED_SECTIONS`` must
    pass (exit 0); another one runs, its fresh number printed, with no
    verdict taken.  The fresh ``serve_live`` records of the live and
    refresh runs must carry every tier and histogram field, and the
    refresh run's ``serve_refresh`` record both gated metrics.  Then
    the self-test: ``serve`` with ``--inject-slowdown 10`` must exit 1
    (against the fresh ``serve`` record when the committed history has
    none of this card).  Each run is a serve CLI process of its own,
    the road4000 path phase ``road4000`` counts launches on; fresh
    records land in ``chiprun_out/bench_gate_fresh_torch_*.json``."""
    import torch

    from repro_torch.launch import bench_gate
    from repro_torch.perflog import read_records
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    history = ROOT / "BENCH_torch_serve.json"
    card = torch.cuda.get_device_name(0)
    committed = [r for r in read_records(str(history))
                 if r.get("device_name") == card]
    res: dict = {"card": card, "committed_records": len(committed),
                 "gated": list(GATED_SECTIONS), "runs": {}}
    print(f"  gate: {len(committed)} committed records of {card}")
    for name, flags in GATE_SECTIONS:
        run = _gate_run(flags, out_dir / f"bench_gate_fresh_torch_{name}"
                        ".json")
        res["runs"][name] = run
        if name in GATED_SECTIONS and run["rc"]:
            raise AssertionError(f"gate {name} failed: {run['lines']}")
    for name in ("live", "refresh"):
        recs = res["runs"][name]["records"]
        live = [r for r in recs if r["section"] == "serve_live"]
        if len(live) != 1 or live[0]["oracle_bad"]:
            raise AssertionError(f"gate {name}: serve_live {live}")
        bench_gate.require_tier_fields(live[0])
        bench_gate.require_hist_fields(live[0])
    refresh = [r for r in res["runs"]["refresh"]["records"]
               if r["section"] == "serve_refresh"]
    if len(refresh) != 1 or not all(
            isinstance(refresh[0].get(k), (int, float))
            for k in ("refresh_max_s", "max_serving_gap_ms")):
        raise AssertionError(f"gate refresh: serve_refresh {refresh}")
    selftest_history = None
    if not any(r["section"] == "serve" for r in committed):
        selftest_history = out_dir / "bench_gate_selftest_history.json"
        selftest_history.write_text(json.dumps(
            res["runs"]["serve"]["records"]))
    res["selftest_history"] = ("committed" if selftest_history is None
                               else "fresh serve record")
    run = _gate_run(("--inject-slowdown", "10"),
                    out_dir / "bench_gate_fresh_torch_selftest.json",
                    history=selftest_history)
    res["runs"]["selftest"] = run
    if run["rc"] != 1:
        raise AssertionError(f"gate self-test: --inject-slowdown 10 "
                             f"exited {run['rc']}: {run['lines']}")
    res["numbers"] = {
        "serve_us_per_query": _fresh(res, "serve", "serve", "us_per_query"),
        "live_p99_ms": _fresh(res, "live", "serve_live", "p99_ms"),
        "refresh_max_s": _fresh(res, "refresh", "serve_refresh",
                                "refresh_max_s"),
        "max_serving_gap_ms": _fresh(res, "refresh", "serve_refresh",
                                     "max_serving_gap_ms"),
        "host_build_wall_s": _fresh(res, "host_build", "host_build",
                                    "wall_s"),
        "seconds": {k: v["s"] for k, v in res["runs"].items()}}
    print(f"  gate: {res['numbers']}")
    for run in res["runs"].values():
        del run["records"]
    return res


def _fresh(res: dict, run: str, section: str, key: str):
    """``key`` of the gate run ``run``'s fresh ``section`` record."""
    recs = [r for r in res["runs"][run]["records"]
            if r["section"] == section]
    return recs[-1][key] if recs else None


def _events_ms(fn) -> tuple:
    """One call of ``fn``, synchronised, timed with CUDA events: (its
    result, ms).  Host work inside the call (a fixpoint test) counts."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _sharded() -> dict:
    """The multi-device serving and build path on one card, on the
    indices phases 4 and 6 built (no new road64k build): road4000
    through ``serve --mode fused`` and ``--mode sharded`` (5 batches of
    1,024, 64 validated each, 0 mismatches);
    road64k (3 levels) through ``serve_sharded`` on a one-card mesh and on
    ``cuda:0`` repeated four times, a batch of 1,024 and a ragged one of
    1,000, each == ``serve_step`` == the planner (warmed, so its buckets
    replay as CUDA graphs; the phase prints how many), 32 == Dijkstra; 64
    road4000 answers of ``serve_sharded`` == the port's
    ``DislandEngine`` on ``cuda:0`` x 4, and from copies of the index:
    one on the CPU served on the one-card mesh (its replica copied to
    the card) and on a mesh of the CPU and the card (from the CPU copy
    and from the card's index); the sharded build: ``fw_fragments_sharded`` ==
    ``frag_apsp`` and ``super_apsp_sharded`` (Bellman-Ford) == the
    dense ``d_super[:S, :S]`` at road4000 and == ``ops.fw_apsp`` of the
    overlay at road64k (n = 4,613), each on a plan made afresh from the
    host index (a refresh phase moved the stored plan's weights on).
    The references are computed first; the counters are zeroed just
    before the path and read just after.  Then both sharded build
    functions, the blocked FW closure of each overlay (``ops.fw_apsp``,
    the Bellman-Ford's dense counterpart) and kernel 3 at road64k's
    fragments ([130, 496, 496], its blocked route ``fw_dist_blocked``)
    are timed with CUDA events, kernel 3 also by device time, beside the
    witness ``fw_next_blocked`` on the same input, its plain version and
    its bound."""
    import functools

    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import (make_build_plan, serve_step,
                                                super_overlay, super_weights)
    from repro_torch.core.dist_engine import (QueryPlanner,
                                              fw_fragments_sharded,
                                              serve_sharded,
                                              super_apsp_sharded)
    from repro_torch.core.engine import DislandEngine
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    one = make_host_mesh((1,), ("data",))
    meshes = {"one_card": one,
              "cuda0_x4": Mesh((one.devices[0],) * 4, (4,), ("data",))}
    rng = np.random.default_rng(21)
    # -- references, before the count
    g64, dix64 = _BUILT["road64k"]
    planner64 = QueryPlanner(dix64)
    planner64.warmup(1024)
    batches = []
    for q in (1024, 1000):
        s, t = rng.integers(0, g64.n, q), rng.integers(0, g64.n, q)
        step = serve_step(dix64, torch.from_numpy(s).cuda(),
                          torch.from_numpy(t).cuda()).cpu().numpy()
        oracle = np.array([dijkstra.pair(g64, int(a), int(b))
                           for a, b in zip(s[:32], t[:32])], np.float32)
        batches.append((s, t, step, planner64.query(s, t), oracle))
    g4, dix4 = _BUILT["road4000"]
    s4, t4 = rng.integers(0, g4.n, 64), rng.integers(0, g4.n, 64)
    engine4 = DislandEngine(_HOST["road4000"][0]).query_many(
        np.stack([s4, t4], 1)).astype(np.float32)
    dix4_cpu = convert.device_index_from_numpy(
        convert.device_index_to_numpy(dix4), "cpu")
    mixed = Mesh((torch.device("cpu"), one.devices[0]), (2,), ("data",))
    copied = {"card_from_cpu": (one, dix4_cpu),
              "cpu_and_card_from_cpu": (mixed, dix4_cpu),
              "cpu_and_card_from_card": (mixed, dix4)}
    builds = {}
    for graph in ("road4000", "road64k"):
        dix = _BUILT[graph][1]
        plan = make_build_plan(_HOST[graph][0])
        super_weights(plan, dix.frag_apsp.cpu().numpy())
        S = plan.S
        want = (dix.d_super[:S, :S] if dix.hierarchy_levels == 1 else
                ops.fw_apsp(torch.from_numpy(super_overlay(plan)).cuda()))
        edges = (np.concatenate([plan.sup_src, plan.sup_dst]),
                 np.concatenate([plan.sup_dst, plan.sup_src]),
                 np.concatenate([plan.sup_w, plan.sup_w]))
        builds[graph] = (dix, plan, want, edges)
    # -- the path, counted
    torch.cuda.synchronize()
    _reset_counts()
    cli = {}
    for mode in ("fused", "sharded"):
        cli[mode] = serve.run(serve.parse_args([
            "--graph", "road4000", "--batches", "5", "--batch-size",
            "1024", "--validate", "64", "--device", "cuda", "--mode",
            mode]))
    served = {name: [serve_sharded(mesh, dix64, s, t).cpu().numpy()
                     for s, t, *_ in batches]
              for name, mesh in meshes.items()}
    got4 = serve_sharded(meshes["cuda0_x4"], dix4, s4, t4).cpu().numpy()
    got4_copied = {name: serve_sharded(mesh, dix, s4, t4)
                   for name, (mesh, dix) in copied.items()}
    built = {graph: {
        "frag": {name: fw_fragments_sharded(mesh, plan.frag_adj)
                 for name, mesh in meshes.items()},
        "bf": super_apsp_sharded(one, *edges, plan.S)}
        for graph, (dix, plan, want, edges) in builds.items()}
    torch.cuda.synchronize()
    res = {"launches": _read_counts(),
           "planner_graphs": dict(planner64.graph_counts)}
    print(f"  sharded: road64k planner buckets replayed / captured / "
          f"eager: {planner64.graph_counts['replay']} / "
          f"{planner64.graph_counts['capture']} / "
          f"{planner64.graph_counts['eager']}, graphs captured "
          f"{planner64.graph_counts['captured']}")
    # -- checks
    checks = {
        "planner_replayed": planner64.graph_counts["replay"] > 0,
        "cli_validated": all(cli[m]["mismatches"] == 0
                             and serve.failures(cli[m]) == 0
                             for m in cli),
        "road4000_engine": bool(np.array_equal(got4, engine4)),
    }
    for name, got in got4_copied.items():
        checks[f"road4000_engine_{name}"] = bool(
            got.device == copied[name][0].devices[0]
            and np.array_equal(got.cpu().numpy(), engine4))
    for name in meshes:
        for (s, t, step, planned, oracle), got in zip(batches,
                                                      served[name]):
            key = f"road64k_{name}_q{s.size}"
            checks[key] = bool(np.array_equal(got, step)
                               and np.array_equal(got, planned)
                               and np.array_equal(got[:32], oracle))
    for graph, (dix, plan, want, edges) in builds.items():
        for name, frag in built[graph]["frag"].items():
            checks[f"{graph}_frag_{name}"] = bool(torch.equal(
                frag, dix.frag_apsp))
        checks[f"{graph}_super_bf"] = bool(torch.equal(built[graph]["bf"],
                                                       want))
    res["cli"] = {m: {k: cli[m][k] for k in (
        "mode", "median_batch_ms", "us_per_query", "warmup_s",
        "mismatches", "peak_device_mb")} for m in cli}
    # -- timings (after the count)
    timing = {}
    for graph, (dix, plan, want, edges) in builds.items():
        adj = torch.from_numpy(plan.frag_adj).cuda()
        ov = torch.from_numpy(super_overlay(plan)).cuda()
        _, cold = _events_ms(lambda: super_apsp_sharded(one, *edges, plan.S))
        _, warm = _events_ms(lambda: super_apsp_sharded(one, *edges, plan.S))
        timing[graph] = {
            "S": plan.S, "directed_edges": int(edges[0].size),
            "frag_shape": list(plan.frag_adj.shape),
            "fw_fragments_sharded_ms": _time_ms(
                lambda: fw_fragments_sharded(one, adj), 5),
            "super_apsp_sharded_ms": warm,
            "super_apsp_sharded_first_ms": cold,
            "fw_apsp_overlay_ms": _time_ms(lambda: ops.fw_apsp(ov), 5)}
    adj = torch.from_numpy(builds["road64k"][1].frag_adj).cuda()
    b, n = adj.shape[0], adj.shape[1]
    want = ops.fw_batch(adj, force="ref")
    plain_ms = _time_ms(lambda: ops.fw_batch(adj, force="ref"), 1)
    bound, by = _bound_ms(8.0 * b * n * n, 2.0 * b * n ** 3)
    tag = f"b={b} n={n} (road64k fw_fragments_sharded)"
    for key, name, kern in (
            ("kernel3", "fw_batch_cuda -> fw_dist_blocked",
             functools.partial(fw.fw_batch_cuda, adj)),
            ("kernel1_blocked", "fw_next_blocked_cuda",
             lambda: fw.fw_next_blocked_cuda(adj)[0])):
        got = kern()
        torch.cuda.synchronize()
        res[key] = {
            "case": f"{name} {tag}", "kernel": name, "b": b, "n": n,
            "equal": bool(torch.equal(got, want)),
            "max_abs_err": _max_abs_err(got, want), "ms": _time_ms(kern, 5),
            "device_ms": _device_ms(kern, 3), "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}
        del got
        checks[f"{key}_equal"] = res[key]["equal"]
    res["kernel3"]["inf_share"] = float(torch.isinf(adj).double().mean())
    res["timing"], res["checks"] = timing, checks
    print(f"  sharded: cli {res['cli']}; build {timing}; kernel 3 "
          f"{res['kernel3']}, beside {res['kernel1_blocked']}; launches "
          f"{res['launches']}")
    if not all(checks.values()):
        raise AssertionError(f"sharded: {checks}")
    return res


# ---------------------------------------------------------------------------
# phase 10: the training path (no kernel of the port runs in it)
# ---------------------------------------------------------------------------
#: checkpoints of the full-width granite-moe run (git-ignored; removed
#: after the phase)
TRAIN_CKPT = ROOT / ".train_ckpt"
#: decode == prefill tolerance on bf16 logits: max |dec - ref| over
#: max |ref|, ~13 units of bf16 rounding (2**-8) gathered over 24 layers
DECODE_REL_TOL = 0.05


def _tree_bits_equal(a, b) -> bool:
    """Same structure, dtypes, shapes and devices, every leaf equal bit
    for bit (bf16 through its int16 view)."""
    import torch
    from repro_torch.checkpoint.manager import tree_flatten
    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    if repr(da) != repr(db) or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if (x.dtype, x.shape, x.device) != (y.dtype, y.shape, y.device):
            return False
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x, y):
            return False
    return True


def _run_record(res: dict, per_step: int, unit: str, base: int) -> dict:
    """Median step seconds after the first step, the rate, checkpoint
    save seconds, and the peak device memory above what was allocated
    before the run began (``base``)."""
    import numpy as np
    import torch
    times = res["step_s"][1:] or res["step_s"]
    med = float(np.median(times))
    peak = torch.cuda.max_memory_allocated()
    return {"steps": len(res["step_s"]), "median_step_s": med,
            f"{unit}_per_s": per_step / med, "save_s": res["save_s"],
            "peak_mib": (peak - base) / 2**20, "base_mib": base / 2**20,
            "losses": res["losses"], "grad_norms": res["grad_norms"]}


def _release() -> int:
    """Collect garbage, return the cache to the card, reset the peak;
    -> the bytes still allocated (the next run's base)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _train_card_vs_cpu() -> dict:
    """Reduced float32 granite-moe (MoE) and granite-8b (dense) at
    ``tests/test_arch_smoke.py``'s dims: the same parameters and tokens
    on the card and on the CPU give the same loss and gradients, and one
    AdamW step from the same gradients the same new parameters."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import tree_leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer
    from repro_torch.models.common import Shardings
    from repro_torch.optim import adamw_init, adamw_update
    sh = Shardings(mesh=None)
    out = {}
    for arch in ("granite-moe-1b-a400m", "granite-8b"):
        base = get_arch(arch).model_cfg
        cfg = dataclasses.replace(
            base, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=128, dtype=torch.float32, attn_chunk=16,
            n_experts=4 if base.moe else 0, top_k=min(base.top_k, 2),
            gather_fsdp_in_body=False, seq_shard_activations=False)
        p_cpu = transformer.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")
        p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 32)).astype(np.int32))

        def loss_fn(p, b):
            return transformer.forward_loss(cfg, sh, p, b)
        l_c, g_c = value_and_grad(loss_fn, p_cpu, toks)
        l_g, g_g = value_and_grad(loss_fn, p_gpu, toks.cuda())
        torch.testing.assert_close(l_g.cpu(), l_c, rtol=1e-5, atol=0)
        grad_err = 0.0
        for a, b in zip(tree_leaves(g_c), tree_leaves(g_g)):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-5)
            grad_err = max(grad_err, float((b.cpu() - a).abs().max()))
        g_same = tree_map(lambda t: t.cuda(), g_c)
        n_c, _, _ = adamw_update(p_cpu, g_c, adamw_init(p_cpu), lr=3e-4)
        n_g, _, _ = adamw_update(p_gpu, g_same, adamw_init(p_gpu),
                                 lr=3e-4)
        adam_err = 0.0
        for a, b in zip(tree_leaves(n_c), tree_leaves(n_g)):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=1e-7)
            adam_err = max(adam_err, float((b.cpu() - a).abs().max()))
        out[arch] = {"loss_cpu": float(l_c), "loss_card": float(l_g),
                     "grad_max_abs_err": grad_err,
                     "adamw_max_abs_err": adam_err}
    print(f"  card vs CPU (allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}; loss rtol 1e-5, "
          f"grads rtol 1e-4 atol 1e-5, AdamW step rtol 1e-6 atol 1e-7): "
          f"{out}")
    return out


def _decode_check(params, n_steps: int = 16) -> dict:
    """granite-moe's prefill on a 4,096-token prompt, then ``n_steps``
    greedy decode steps, each held against the prefill of the extended
    prompt.  The capacity factor is raised to E/K so no token is dropped
    (cap >= N): drops differ between a prompt and one token and are
    legitimate MoE behaviour, as in ``tests/test_models.py``."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batches
    from repro_torch.models import transformer
    from repro_torch.models.common import Shardings
    base = get_arch("granite-moe-1b-a400m").model_cfg
    cfg = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.top_k)
    sh = Shardings(mesh=None)
    toks = torch.from_numpy(next(lm_batches(1, 4096, cfg.vocab,
                                            seed=7))).cuda()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(cfg, sh, params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pad = (0, 0, 0, 0, 0, n_steps)
    cache = {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad),
             "len": cache["len"]}
    tok = logits.argmax(-1)
    rels, agree, dec_s = [], 0, []
    for _ in range(n_steps):
        toks = torch.cat([toks, tok[:, None].to(toks.dtype)], dim=1)
        t0 = time.perf_counter()
        dec, cache = transformer.decode_step(cfg, sh, params, cache, tok)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        ref, _ = transformer.prefill(cfg, sh, params, toks)
        ref, dec = ref.float(), dec.float()
        rels.append(float((dec - ref).abs().max() / ref.abs().max()))
        agree += int(torch.equal(dec.argmax(-1), ref.argmax(-1)))
        tok = ref.argmax(-1)
    res = {"prompt": 4096, "steps": n_steps, "rel_err": rels,
           "max_rel_err": max(rels), "tol": DECODE_REL_TOL,
           "argmax_agree": agree, "prefill_4096_s": prefill_s,
           "decode_step_s": dec_s}
    print(f"  granite-moe decode vs prefill: max rel err {max(rels):.5f} "
          f"(tolerance {DECODE_REL_TOL}), argmax agrees {agree}/{n_steps}"
          f", prefill 4,096 {prefill_s:.3f}s")
    if not max(rels) <= DECODE_REL_TOL:
        raise AssertionError(f"decode != prefill: {rels}")
    return res


def _train_granite_moe(batch: int = 1) -> dict:
    """granite-moe-1b-a400m at its published dims through
    ``repro_torch.launch.train``: 6 steps at seq 4,096 with a checkpoint
    every 3, the state on disk at step 6 == the run's own bit for bit,
    then 2 more steps in a fresh process that resumes at step 6.  The
    checkpoints (~13 GB each) are removed however the runs end."""
    import shutil
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    try:
        return _granite_moe_runs(batch)
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)


def _granite_moe_runs(batch: int) -> dict:
    import math
    import os
    import re

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    args = ["--arch", "granite-moe-1b-a400m", "--batch", str(batch),
            "--seq", "4096", "--ckpt", str(TRAIN_CKPT), "--ckpt-every", "3"]
    base = _release()
    t0 = time.perf_counter()
    res = train.main(args + ["--steps", "6"])
    run_s = time.perf_counter() - t0
    rec = _run_record(res, batch * 4096, "tokens", base)
    state = (res.pop("params"), res.pop("opt"))
    mgr = CheckpointManager(str(TRAIN_CKPT))
    rec["saved_steps"] = mgr.all_steps()
    t0 = time.perf_counter()
    step, restored = mgr.restore(state)
    rec["restore_s"] = time.perf_counter() - t0
    rec["restored_step"] = step
    rec["restore_bit_equal"] = step == 6 and _tree_bits_equal(restored,
                                                              state)
    params = state[0]
    del restored, state
    _release()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--steps", "8"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    rec["resume_process_s"] = time.perf_counter() - t0
    print("\n".join("  | " + ln for ln in proc.stdout.splitlines()))
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"resumed train exited {proc.returncode}")
    last = re.search(r"loss: first=(\S+) last=(\S+)", proc.stdout)
    summ = re.search(r"straggler summary: \{'steps': (\d+), "
                     r"'median_s': (\S+),", proc.stdout)
    peak = re.search(r"peak device memory (\S+) MiB", proc.stdout)
    rec["resume"] = {
        "restored_step_6": "restored step 6" in proc.stdout,
        "steps": int(summ.group(1)), "median_step_s": float(summ.group(2)),
        "losses": [float(last.group(1)), float(last.group(2))],
        "peak_mib": float(peak.group(1))}
    losses = rec["losses"] + rec["resume"]["losses"]
    rec["first_run_s"], rec["all_losses"] = run_s, losses
    print(f"  granite-moe train (batch {batch}, seq 4,096): losses "
          f"{[round(x, 4) for x in losses]}; median step "
          f"{rec['median_step_s']:.4f}s, {rec['tokens_per_s']:,.0f} "
          f"tokens/s, peak {rec['peak_mib']:,.0f} MiB; restore "
          f"{rec['restore_s']:.1f}s bit-equal {rec['restore_bit_equal']}; "
          f"resume {rec['resume']}")
    ok = (rec["restore_bit_equal"] and rec["saved_steps"] == [3, 6]
          and rec["resume"]["restored_step_6"]
          and rec["resume"]["steps"] == 2
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0])
    if not ok:
        raise AssertionError(f"granite-moe training: {rec}")
    rec["decode"] = _decode_check(params)
    return rec


def _train() -> dict:
    """Phase ``train``: card == CPU on reduced LMs; granite-moe-1b-a400m
    at its published dims (train, checkpoint, resume in a fresh process,
    decode == prefill); wide-deep at its published dims at the
    ``train_batch`` shape; each of the ten archs at ``--reduced``.  No
    kernel of the port runs in it: the counters are zeroed around it and
    must read 0."""
    import math

    import torch
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_counts()
    out = {"card_vs_cpu": _train_card_vs_cpu(),
           "granite_moe": _train_granite_moe()}
    base = _release()
    res = train.main(["--arch", "wide-deep", "--steps", "4",
                      "--batch", "65536"])
    out["wide_deep"] = _run_record(res, 65536, "samples", base)
    del res
    print(f"  wide-deep train (batch 65,536, 40 x 1,000,000 rows): "
          f"{out['wide_deep']}")
    out["reduced"] = {}
    for arch in list_archs():
        base = _release()
        res = train.main(["--arch", arch, "--steps", "2", "--reduced"])
        # the driver's defaults: 8 x 128 tokens, one road_like(512)
        # graph, 8 samples
        family = get_arch(arch).family
        out["reduced"][arch] = _run_record(
            res, {"lm": 8 * 128, "gnn": 1, "recsys": 8}[family],
            {"lm": "tokens", "gnn": "graphs", "recsys": "samples"}[family],
            base)
        del res
    out["left_mib"] = _release() / 2**20
    print(f"  reduced archs: {out['reduced']}")
    out["launches"] = _read_counts()
    finite = all(math.isfinite(x) for r in
                 [out["wide_deep"]] + list(out["reduced"].values())
                 for x in r["losses"])
    if any(out["launches"].values()) or not finite:
        raise AssertionError(f"train: launches {out['launches']}, "
                             f"finite losses {finite}")
    return out



# ---------------------------------------------------------------------------
# phases 11-13: the sharded GNN forwards, the dry runs, meta against card
# ---------------------------------------------------------------------------
#: sharded == unsharded: at float32 the loss (tests/test_multidevice.py:113
#: and :170); at float64 the loss and every gradient leaf (max |a - b|
#: over max |b|), as the CPU tests hold them.  The float32 gradients are
#: recorded against the float64 dense run, not held to the float32 dense
#: run's bits: at these widths float32 rounding leaves some leaves only
#: ~1e-4-1e-3 from float64 (dimenet's inner layers even on the CPU, where
#: sharded and dense give the same bits), and the card sums its matmuls'
#: and index_add's terms in another order in each layout
GNN_RTOL = 1e-4

#: the dry run's meta peak over the card's peak, both above the bytes
#: held before the step
VS_CARD_RANGE = (0.5, 2.0)
#: processes of the background dry-run sweep (the host has 8 cores; the
#: sweep runs at nice 19 beside the card phases)
DRYRUN_WORKERS = 5
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"


def _card():
    """The card the phases run on (a CPU rehearsal patches this)."""
    import torch
    return torch.device("cuda", 0)


def _gnn_layouts(arch: str, dims: dict, n_out: int, d_edge: int,
                 seed: int = 17, shards: int = 4) -> tuple:
    """(dense batch, owner batch for ``shards`` shards), numpy, at a
    cell's dims.  graphcast: shard s owns nodes [s n/P, (s+1) n/P) and
    e/P incoming edges, their sources uniform over all nodes.  dimenet:
    molecules of n/G nodes, e/G edges (pairs both ways) and 2e/G
    triplets within the molecule, whole molecules per shard.  The owner
    batch is the dense one with ``edge_dst`` (and dimenet's triplets)
    made shard-local; at one shard the two are the same."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, e, df = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
    nl, el = n // shards, e // shards
    f32, i32 = np.float32, np.int32
    dense = {"node_feat": rng.standard_normal((n, df), f32)}
    if arch == "graphcast":
        dense["edge_src"] = rng.integers(0, n, e).astype(i32)
        dense["edge_dst"] = (np.repeat(np.arange(shards), el) * nl
                             + rng.integers(0, nl, e)).astype(i32)
        dense["edge_feat"] = rng.standard_normal((e, d_edge), f32)
        dense["target"] = rng.standard_normal((n, n_out), f32)
        dense["loss_mask"] = (rng.random(n) < 0.9).astype(f32)
    else:
        g_ = dims["n_graphs"]
        npg, epg = n // g_, e // g_
        u = rng.integers(0, npg, (g_, epg // 2))
        v = (u + 1 + rng.integers(0, npg - 1, (g_, epg // 2))) % npg
        off = (np.arange(g_) * npg)[:, None]
        dense["edge_src"] = (np.concatenate([u, v], 1) + off
                             ).ravel().astype(i32)
        dense["edge_dst"] = (np.concatenate([v, u], 1) + off
                             ).ravel().astype(i32)
        eoff = (np.arange(g_) * epg)[:, None]
        tri = 2 * epg
        dense["tri_edge_kj"] = (rng.integers(0, epg, (g_, tri)) + eoff
                                ).ravel().astype(i32)
        dense["tri_edge_ji"] = (rng.integers(0, epg, (g_, tri)) + eoff
                                ).ravel().astype(i32)
        dense["tri_angle"] = rng.uniform(0, np.pi, g_ * tri).astype(f32)
        dense["edge_dist"] = rng.uniform(0.5, 3.0, e).astype(f32)
        dense["graph_id"] = np.repeat(np.arange(g_), npg).astype(i32)
        dense["target_g"] = rng.standard_normal(g_, f32)
    owner = dict(dense)
    owner["edge_dst"] = (dense["edge_dst"]
                         - np.repeat(np.arange(shards), el) * nl).astype(i32)
    if arch == "dimenet":
        tl = dense["tri_edge_kj"].size // shards
        for k in ("tri_edge_kj", "tri_edge_ji"):
            owner[k] = (dense[k] - np.repeat(np.arange(shards), tl) * el
                        ).astype(i32)
    assert owner["edge_dst"].min() >= 0 and owner["edge_dst"].max() < nl
    return dense, owner


def _leaf_errs(got, want) -> list:
    """Per gradient leaf: max |a - b| over max |b| (b's dtype)."""
    from repro_torch.checkpoint.manager import tree_leaves
    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        scale = float(b.abs().max()) or 1.0
        out.append(float((a.to(b.dtype) - b).abs().max()) / scale)
    return out


def _gnn_case(arch: str, shape: str) -> dict:
    """One published-width GNN cell on the card: the sharded loss and
    gradients (owner layout, one-card mesh and ``cuda:0`` x 4) == the
    unsharded ones (dense layout), at float32 the loss and at float64
    the loss and every gradient (``GNN_RTOL``); then 3 steps of the cell's bf16 step
    (``cells.build_cell`` on the one-card mesh): step s, peak MiB above
    the bytes held before, finite losses."""
    import dataclasses
    import math

    import torch
    from repro_torch.checkpoint.manager import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell, gnn_cell_config
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import gnn
    from repro_torch.models.common import Shardings
    from repro_torch.optim import adamw_init
    spec = get_arch(arch)
    cell = spec.shape(shape)
    cfg = gnn_cell_config(spec, cell)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dense_np, owner_np = _gnn_layouts(arch, cell.dims, cfg.n_out,
                                      cfg.d_edge)
    dev = _card()

    def on_card(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    one = make_host_mesh((1, 1), device=dev.type)
    x4 = Mesh((dev,) * 4, (2, 2), ("data", "model"))
    res = {"arch": arch, "shape": shape, "dims": cell.dims,
           "layers": cfg.n_layers, "d_hidden": cfg.d_hidden}
    params = gnn.init_params(cfg32, torch.Generator(dev).manual_seed(3),
                             dev)
    runs = {}
    dense_cfg = dataclasses.replace(cfg32, sharded=False)
    for dt in (torch.float64, torch.float32):
        for name, c, sh, batch in (
                ("dense", dense_cfg, Shardings(None), dense_np),
                ("one_card", cfg32, Shardings(one), dense_np),
                ("cuda0_x4", cfg32, Shardings(x4), owner_np)):
            base = _release()
            b = on_card(batch)
            p = params
            if dt == torch.float64:
                c = dataclasses.replace(c, dtype=dt)
                b = {k: v.double() if v.is_floating_point() else v
                     for k, v in b.items()}
                p = tree_map(lambda w: w.double(), params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = value_and_grad(
                lambda pp, bb, c=c, sh=sh: gnn.forward_loss(c, sh, pp, bb),
                p, b)
            torch.cuda.synchronize()
            runs[str(dt).removeprefix("torch."), name] = (
                float(loss), grads, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 2**20)
            del b, p
    truth_loss, truth = runs["float64", "dense"][:2]
    for (dt, name), (loss, grads, sec, peak) in runs.items():
        ref_loss, ref = runs[dt, "dense"][:2]
        res.setdefault(dt, {})[name] = {
            "loss": loss, "s": sec, "peak_mib": peak,
            "loss_rel_err": abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
            "grad_rel_err": max(_leaf_errs(grads, ref)),
            "grad_rel_err_vs_float64": max(_leaf_errs(grads, truth))}
    del runs, params, truth
    # the cell's bf16 step, 3 times
    bundle = build_cell(arch, shape, one)
    params = gnn.init_params(cfg, torch.Generator(dev).manual_seed(4), dev)
    opt = adamw_init(params)
    b = on_card(dense_np)
    steps_s, losses = [], []
    base = _release()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = bundle.fn(params, opt, b)
        losses.append(float(metrics["loss"]))
        steps_s.append(time.perf_counter() - t0)
    res["bf16_steps"] = {
        "step_s": steps_s, "losses": losses,
        "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
        "base_mib": base / 2**20}
    del params, opt, b
    _release()
    print(f"  {arch} {shape}: float64 {res['float64']}; float32 "
          f"{res['float32']}; bf16 cell steps {res['bf16_steps']}")
    bad = ([("float32", n) for n, r in res["float32"].items()
            if r["loss_rel_err"] > GNN_RTOL]
           + [("float64", n) for n, r in res["float64"].items()
              if max(r["loss_rel_err"], r["grad_rel_err"]) > GNN_RTOL])
    if bad or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} {shape}: sharded != dense on {bad} "
                             f"(rtol {GNN_RTOL}), or losses {losses}")
    return res


def _gnn_sharded() -> dict:
    """Phase ``gnn_sharded``: graphcast (16 layers, d 512) at
    ``minibatch_lg`` and dimenet (6 blocks, d 128) at ``molecule``
    through ``_gnn_case``; no kernel of the port runs (counters zeroed
    around it must read 0)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_counts()
    out = {"graphcast": _gnn_case("graphcast", "minibatch_lg"),
           "dimenet": _gnn_case("dimenet", "molecule")}
    out["launches"] = _read_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"gnn_sharded launched kernels: "
                             f"{out['launches']}")
    return out


def _start_dryrun():
    """Start the dry-run sweep (``repro_torch.launch.dryrun --all --mesh
    both``, every cell afresh into ``DRYRUN_OUT``) in its own session at
    nice 19, with no card visible: it needs none (``meta``)."""
    import os
    import shutil
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(DRYRUN_OUT / "sweep.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--force", "--workers", str(DRYRUN_WORKERS),
         "--out", str(DRYRUN_OUT)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True, preexec_fn=lambda: os.nice(19))
    log.close()
    return proc, time.perf_counter()


def _stop(proc) -> None:
    """Kill ``proc``'s session (the sweep and its pool) if it runs."""
    import os
    import signal
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _dryrun(sweep) -> dict:
    """Phase ``dryrun``: wait for the sweep (all 40 cells on the single
    and multipod meshes); every record ``ok``; then
    ``dryrun_disland`` on both meshes."""
    import json as _json

    from repro_torch.launch import dryrun, dryrun_disland
    proc, t0 = sweep
    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    recs = []
    for arch, shape in dryrun.all_cells():
        for mesh in ("single", "multipod"):
            path = DRYRUN_OUT / f"{arch}__{shape}__{mesh}.json"
            recs.append(_json.loads(path.read_text()) if path.exists()
                        else {"arch": arch, "shape": shape, "mesh": mesh,
                              "ok": False, "error": "no record"})
    disland = dryrun_disland.main(str(DRYRUN_OUT))
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
           for r in recs if not r["ok"]]
    longest = max(recs, key=lambda r: r.get("lower_s", 0))
    out = {"rc": rc, "sweep_wall_s": wall, "cells": len(recs),
           "ok": len(recs) - len(bad), "workers": DRYRUN_WORKERS,
           "sum_run_s": sum(r.get("lower_s", 0) for r in recs),
           "longest": [longest["arch"], longest["shape"], longest["mesh"],
                       longest.get("lower_s")],
           "disland": disland}
    print(f"  dry run: {out['ok']}/{out['cells']} cells ok, sweep "
          f"{wall:.1f}s wall ({DRYRUN_WORKERS} workers, nice 19, beside "
          f"the phases since 'road64k_live'), {out['sum_run_s']:.1f}s of "
          f"cell runs, longest {out['longest']}")
    if rc or bad:
        raise AssertionError(f"dry run: rc {rc}, failed cells {bad}")
    return out


def _peak_above(fn) -> int:
    """Bytes ``fn()`` allocates at its peak on the card above what is
    held before it (after one warm call)."""
    import torch
    fn()
    base = _release()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _dryrun_vs_card() -> dict:
    """Phase ``dryrun_vs_card``: the ``meta`` prediction of a step's
    peak (``opanalysis``' ``peak_live_bytes``) against the card's
    ``max_memory_allocated`` above the bytes held before the step, for
    the wide-deep ``train_batch`` step (``cells.build_cell`` on a
    one-card mesh) and road4000's ``serve_step`` at q = 1,024 (which
    launches kernel 2, ``minplus_twoside_grouped``, counted); each
    ratio within ``VS_CARD_RANGE``."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.core.device_engine import serve_step
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.opanalysis import analyze
    from repro_torch.models import recsys
    from repro_torch.optim import adamw_init
    dev = _card()
    out = {}
    # wide-deep train_batch
    bundle = build_cell("wide-deep", "train_batch",
                        make_host_mesh((1, 1), device=dev.type))
    meta = analyze(bundle.fn, *bundle.args).peak_live_bytes
    cfg = get_arch("wide-deep").model_cfg
    b = get_arch("wide-deep").shape("train_batch").dims["batch"]
    params = recsys.init_params(cfg, torch.Generator(dev).manual_seed(5),
                                dev)
    opt = adamw_init(params)
    gen = torch.Generator(dev).manual_seed(6)
    batch = {"sparse_ids": torch.randint(
        0, cfg.rows_per_field, (b, cfg.n_sparse, cfg.hots_per_field),
        generator=gen, device=dev, dtype=torch.int32),
        "dense": torch.randn((b, cfg.n_dense), generator=gen, device=dev),
        "labels": torch.randint(0, 2, (b,), generator=gen, device=dev,
                                dtype=torch.int32)}
    card = _peak_above(lambda: bundle.fn(params, opt, batch))
    out["wide_deep_train_batch"] = {"meta_bytes": meta, "card_bytes": card,
                                    "ratio": meta / card}
    del params, opt, batch, bundle
    _release()
    # road4000 serve_step at q = 1,024
    g4, dix4 = _BUILT["road4000"]
    dixm = convert.device_index_from_numpy(
        convert.device_index_to_numpy(dix4), "meta")
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.integers(0, g4.n, 1024)).to(dev)
    t = torch.from_numpy(rng.integers(0, g4.n, 1024)).to(dev)
    meta = analyze(serve_step, dixm, s.to("meta"), t.to("meta"))
    _reset_counts()
    card = _peak_above(lambda: serve_step(dix4, s, t))
    launches = _read_counts()
    out["road4000_serve_q1024"] = {
        "meta_bytes": meta.peak_live_bytes, "card_bytes": card,
        "ratio": meta.peak_live_bytes / card, "launches": launches}
    print(f"  meta vs card: {out}")
    bad = [k for k, r in out.items()
           if not VS_CARD_RANGE[0] <= r["ratio"] <= VS_CARD_RANGE[1]]
    if bad or not launches["minplus_twoside_grouped"]:
        raise AssertionError(f"meta/card outside {VS_CARD_RANGE}: {bad}, "
                             f"or kernel 2 not launched: {launches}")
    return out

#: kernel entries the paper phase must launch: kernel 1 (either witness
#: FW route), kernel 2 and kernel 6
PAPER_KERNELS = ("minplus_twoside_grouped", "minplus_twoside_argmin")


def _paper() -> dict:
    """Exp-5, Exp-7 and Exp-8 of the port's paper harness
    (``repro_torch.paper.tables``) on the card at the reference's sizes,
    counters zeroed just before and read just after: every Exp-5
    bucket's ``disland-batched`` answers == Dijkstra (computed here),
    ``match == 1`` in every Exp-7 round, ``exact == 1`` in Exp-8; the
    CSV rows are printed and returned, with the ms of every full
    (generation-2) garbage collection during each experiment (a pause
    inside a timed region shows in its row)."""
    import gc

    import numpy as np
    from repro_torch.core import dijkstra
    from repro_torch.paper import tables
    rows: list = []
    answers: dict = {}
    pauses: dict = {}
    started = [0.0, ""]

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                pauses.setdefault(started[1], []).append(
                    (time.perf_counter() - started[0]) * 1e3)
    gc.callbacks.append(on_gc)
    _reset_counts()
    try:
        for fn, kw in ((tables.exp5_query_latency, {"answers": answers}),
                       (tables.exp7_incremental_refresh, {}),
                       (tables.exp8_path_reconstruction, {})):
            started[1] = fn.__name__
            fn(rows, device="cuda", **kw)
    finally:
        gc.callbacks.remove(on_gc)
    launches = _read_counts()
    for row in rows:
        print(f"  {row}")
    _name, g = next(tables._graphs((6000,)))
    bad = {}
    for bucket, (pairs, served) in answers.items():
        want = np.asarray([dijkstra.pair(g, int(a), int(b))
                           for a, b in pairs], np.float32)
        bad[bucket] = int((served != want).sum())
    parts = [r.split(",") for r in rows if not r.split(",")[1] == "graph"]
    match = [p[10] for p in parts if p[0] == "exp7"]
    exact = [p[5] for p in parts if p[0] == "exp8"]
    res = {"rows": rows, "launches": launches, "exp5_mismatches": bad,
           "exp7_match": match, "exp8_exact": exact,
           "gc_gen2_ms": pauses}
    print(f"  paper: exp5 batched answers against Dijkstra, mismatches "
          f"{bad}; exp7 match {match}; exp8 exact {exact}; full GCs (ms) "
          f"{pauses}; launches {launches}")
    if (sum(bad.values()) or len(bad) != 6 or match != ["1"] * 3
            or exact != ["1"] * 3):
        raise AssertionError(f"paper: {res}")
    if launches["fw_next_reg"] + launches["fw_next_blocked"] <= 0:
        raise AssertionError("paper: kernel 1 (witness FW) never launched")
    _require_launched(res, "paper", PAPER_KERNELS)
    return res


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description="On-card smoke test of the "
                                 "PyTorch/CUDA port.")
    ap.add_argument("--only", default="", help="comma-separated phases to "
                    "run (besides build); the end-of-run launch checks and "
                    "kernel table need every phase and are left out")
    only = {p for p in ap.parse_args(argv).only.split(",") if p}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    report: dict = {"phases": {}}
    fw_cases: list = []
    ts_cases: list = []
    new_cases: list = []
    slice3_cases: list = []
    grouped_cases: list = []
    gather_cases: list = []

    def phase(name, fn):
        if only and name not in only | {"build"}:
            return
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            report[name] = fn()
            ok = True
        except Exception:                      # report, go on, fail at end
            traceback.print_exc()
            ok = False
        report["phases"][name] = {"ok": ok,
                                  "s": time.perf_counter() - t0}
        print(f"== {name}: {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

    def build():
        took = _build.build()
        for name in _build.SOURCES:
            log = _build.lib_path(name).with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if any(w in line for w in ("registers", "smem", "spill")):
                        print(f"  ptxas {name}: {line.strip()}")
        print(f"  kernel build seconds: {took}")
        return took

    phase("build", build)
    print("kernel checks: tolerance exact (torch.equal on dist, nxt and "
          "out); integer-valued inputs keep every sum below 2**24")
    phase("fw_kernel", lambda: _check_fw([
        ("reg b=407 n=8 (road4000 piece bucket)", 407, 8, "ragged", ()),
        ("reg b=6 n=32 (road4000 piece bucket)", 6, 32, "ragged", ()),
        ("reg b=6211 n=8 (road64k piece bucket)", 6211, 8, "ragged", ()),
        ("reg b=75 n=32 (road64k piece bucket)", 75, 32, "ragged", ()),
        ("reg b=6211 n=8 ties", 6211, 8, "ties", ()),
        ("reg b=75 n=32 ties all-inf block", 75, 32, "ties", (3,)),
        ("reg b=8 n=8 all-inf blocks", 8, 8, "ragged", (1, 5)),
        ("reg b=64 n=64 ties", 64, 64, "ties", ()),
        ("reg b=9 n=5 ties", 9, 5, "ties", ()),
        ("reg b=13 n=17 ties", 13, 17, "ties", ()),
        ("reg b=7 n=33 all-inf block", 7, 33, "ragged", (2,)),
        ("b=36 n=128", 36, 128, "ragged", ()),
        ("b=36 n=96", 36, 96, "ragged", ()),
        ("b=1 n=4613", 1, 4613, "ragged", ()),
        ("b=4 n=496 all-inf block", 4, 496, "ragged", (2,)),
        ("b=130 n=496 (frag_stage)", 130, 496, "ragged", ()),
        ("b=3 n=1000 ties all-inf block", 3, 1000, "ties", (1,)),
    ], fw_cases))
    phase("twoside_kernel", lambda: _check_twoside([
        ("q=16 S+1=480", 16, 480, 0.2),
        ("q=1024 S+1=480", 1024, 480, 0.2),
        ("q=16 S+1=4614", 16, 4614, 0.2),
        ("q=1024 S+1=4614", 1024, 4614, 0.2),
        ("q=64 S+1=480 all-inf rows", 64, 480, 1.0),
    ], ts_cases))
    phase("hier_kernel_shapes", lambda: (
        _check_fw([("b=6 n=1024 (sf_stage)", 6, 1024, "ragged", ()),
                   ("b=3 n=1024 (sf_stage)", 3, 1024, "ragged", ())],
                  fw_cases),
        _check_twoside([("q=1024 S_top+1=1712", 1024, 1712, 0.2)],
                       ts_cases)))
    phase("fw_batch_kernel", lambda: _check_fw_batch([
        ("fw_batch b=1 n=128", 1, 128, ()),
        ("fw_batch b=1 n=64", 1, 64, ()),
        ("fw_batch b=3 n=100", 3, 100, ()),
        ("fw_batch b=2 n=200", 2, 200, ()),
        ("fw_batch b=2 n=240", 2, 240, (1,)),
        ("fw_batch b=3 n=300", 3, 300, ()),
        ("fw_batch b=4 n=496 all-inf block", 4, 496, (1,)),
        ("fw_batch b=3 n=193 all-inf", 3, 193, (0, 1, 2)),
        ("fw_batch b=5 n=129 (n = 2 k-blocks + 1)", 5, 129, ()),
    ], new_cases))
    phase("minplus_kernels", lambda: _check_minplus([
        ("accum phase2 row C[128,1792] A[128,128] B[128,1792] (C=B)",
         128, 128, 1792, "alias"),
        ("accum phase2 col C[1792,128] A[1792,128] B[128,128]",
         1792, 128, 128, True),
        ("accum phase3 C[1792,1792] A[1792,128] B[128,1792]",
         1792, 128, 1792, True),
        ("accum m,k,n=100,37,250", 100, 37, 250, True),
        ("minplus [1,1712]x[1712,1712]", 1, 1712, 1712, False, "cold"),
        ("minplus [1,4614]x[4614,4614]", 1, 4614, 4614, False, "cold"),
        ("minplus [1,480]x[480,480]", 1, 480, 480, False, "cold"),
        ("minplus m=8 [8,1712]x[1712,1712] (GEMV, threshold)", 8, 1712,
         1712, False),
        ("minplus m=9 [9,1712]x[1712,1712] (tiles)", 9, 1712, 1712,
         False),
        ("minplus [3,300]x[300,257] negative", 3, 300, 257, False, "neg"),
        ("minplus [33,77]x[77,129]", 33, 77, 129, False),
    ], new_cases))
    phase("minplus_into_kernel", lambda: _check_minplus_into([
        ("into phase3 D[1728,1728] K=[576,640)", 1728, 64, 576, "cross"),
        ("panels D[1728,1728] K=[576,640)", 1728, 64, 576, "panels"),
        ("into phase2 row D[1728,1728] K=[576,640)", 1728, 64, 576, "row"),
        ("into phase2 col D[1728,1728] K=[576,640)", 1728, 64, 576, "col"),
        ("into phase3 D[1792,1792] K=[512,640)", 1792, 128, 512, "cross"),
        ("panels D[1792,1792] K=[512,640)", 1792, 128, 512, "panels"),
        ("panels D[1728,1728] K=[1664,1728) (last)", 1728, 64, 1664,
         "panels"),
        ("into phase3 D[4736,4736] K=[2304,2432)", 4736, 128, 2304,
         "cross"),
        ("panels D[4736,4736] K=[2304,2432)", 4736, 128, 2304, "panels"),
        ("into phase2 col D[300,300] K=[128,256)", 300, 128, 128, "col"),
    ], new_cases))
    phase("fw_apsp", lambda: _check_fw_apsp([
        ("fw_apsp n=1711", 1711, None, 0.995),
        ("fw_apsp n=1711 block=128", 1711, 128, 0.995),
        ("fw_apsp n=4661", 4661, None, 0.995),
        ("fw_apsp n=4661 block=64", 4661, 64, 0.995),
        ("fw_apsp n=100 block=32", 100, 32, 0.9),
    ], new_cases))
    phase("twoside_argmin_kernel", lambda: _check_twoside_argmin([
        ("argmin q=16 S+1=480", 16, 480, "ragged"),
        ("argmin q=1024 S+1=480", 1024, 480, "ragged"),
        ("argmin q=16 S+1=4614", 16, 4614, "ragged"),
        ("argmin q=1024 S+1=4614", 1024, 4614, "ragged"),
        ("argmin q=1024 S_top+1=1712", 1024, 1712, "ragged"),
        ("argmin q=64 S+1=480 all-inf rows", 64, 480, "inf"),
        ("argmin q=1024 S+1=480 ties {0,1,2}", 1024, 480, "ties"),
        ("argmin q=100 k=1712 ties {0,1,2}", 100, 1712, "ties"),
        ("argmin serve q=16 S+1=480", 16, 480, "serve"),
        ("argmin serve q=1024 S+1=480", 1024, 480, "serve"),
        ("argmin serve sorted q=1024 S+1=480", 1024, 480, "serve sorted"),
        ("argmin serve ties q=16 S+1=480", 16, 480, "serve ties"),
        ("argmin serve ties q=1024 S+1=480", 1024, 480, "serve ties"),
    ], slice3_cases))
    def label_merge_kernel():
        _check_label_merge([
            ("merge q=1024 W=1712", 1024, 1712, None),
            ("merge q=1024 W=480", 1024, 480, None),
            ("merge q=1024 W=4661 (odd W)", 1024, 4661, None),
            ("merge q=37 W=300 one all-inf row", 37, 300, 5),
            ("merge q=33 W=299 (odd W)", 33, 299, 0),
        ], slice3_cases)
        return _check_label_merge_rows(MERGE_ROWS_CASES, slice3_cases)

    phase("label_merge_kernel", label_merge_kernel)
    phase("gather_minplus_kernel",
          lambda: _check_gather_minplus(gather_cases))
    phase("small_reference", _small_reference)
    phase("road4000", lambda: _main_path("road4000", 64, json_out=True))
    phase("road4000_levels", _level_differential)
    phase("road4000_refresh", _road4000_refresh)
    # road64k's path loop is one batch of 16: the host unwinder takes
    # ~1.7 s a path there (PERF.md)
    def road64k():
        res = _main_path(
            "road64k", 32, sources=(0, 31_000, 61_000),
            path_args=("--path-batches", "1", "--path-batch-size", "16",
                       "--expect-hierarchy", "3", "--max-s2-ratio", "0.5"),
            n_hubs=2048)
        res["first_hops"] = _first_hops_check("road64k")
        return res

    phase("road64k", road64k)
    phase("twoside_grouped", lambda: _check_twoside_grouped(
        _grouped_cases(), grouped_cases))
    phase("road64k_refresh", _road64k_refresh)
    phase("road250k", _road250k)
    phase("road4000_live", _road4000_live)
    phase("gate", _gate)
    # the dry-run sweep needs no card: it runs at nice 19 in its own
    # processes beside the phases from here on (none of them gated on
    # time), and phase dryrun waits for it
    sweep = (_start_dryrun() if not only or "dryrun" in only
             else (None, 0.0))
    try:
        phase("road64k_live", _road64k_live)
        phase("sharded", _sharded)
        phase("train", _train)
        phase("gnn_sharded", _gnn_sharded)
        phase("dryrun", lambda: _dryrun(sweep))
    finally:
        _stop(sweep[0])
    phase("dryrun_vs_card", _dryrun_vs_card)
    phase("paper", _paper)

    report["fw_cases"], report["ts_cases"] = fw_cases, ts_cases
    report["new_cases"], report["slice3_cases"] = new_cases, slice3_cases
    report["grouped_cases"] = grouped_cases
    report["gather_cases"] = gather_cases
    report["profiler_windows"] = WINDOWS
    print(f"profiler windows: {WINDOWS}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    report["card"] = card
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=str))
    failed = [k for k, v in report["phases"].items() if not v["ok"]]
    if failed or not card:
        print(f"chip_smoke: FAILED phases {failed}"
              + ("" if card else "; nvidia-smi gave no card"),
              file=sys.stderr)
        return 1
    if only:
        print(card)
        print(json.dumps({"ok": True, "phases": sorted(report["phases"])}))
        return 0

    def pick(cases, label, kernel=None):
        return next(c for c in cases if c["case"] == label
                    and kernel in (None, c["kernel"]))

    try:
        _require_launched(report["road4000"], "road4000",
                          ("fw_next_reg", "fw_next_blocked",
                           "minplus_twoside_grouped",
                           "minplus_twoside_argmin"))
        for graph in ("road64k", "road250k"):
            _require_launched(report[graph], graph, (
                "fw_next_reg", "fw_batch", "minplus_accum_panels",
                "minplus_accum_into", "minplus", "fw_next_blocked",
                "minplus_twoside_grouped", "minplus_twoside_argmin",
                "label_merge_rows", "gather_minplus",
                "gather_minplus_twoside"))
        for path in ("road4000_live", "road64k_live"):
            _require_launched(report[path], path,
                              ("label_merge_rows",
                               "minplus_twoside_grouped", "fw_next_reg",
                               "fw_next_blocked"))
        _require_launched(report["sharded"], "sharded",
                          ("minplus_twoside_grouped", "fw_batch",
                           "fw_dist_blocked", "minplus_accum_panels",
                           "minplus_accum_into"))
        # the main paths, the refresh epochs, the live runs, the
        # sharded path and the paper phase (each counted from zero just
        # before it, read just after)
        launches = {name: sum(report[path]["launches"][name] for path in (
            "road4000", "road64k", "road4000_refresh", "road64k_refresh",
            "road4000_live", "road64k_live", "sharded", "paper",
            "road250k")) + report["road250k"]["refresh"]["launches"][name]
            for name, _m, _a in KERNELS}
        # the fresh-output accumulate and the dense label merge left the
        # main paths (for the in-place accumulate and the merge through
        # row ids): timed beside their replacements, never run there
        for name in OFF_MAIN_PATH:
            if launches.pop(name):
                raise AssertionError(f"main paths launched {name}")
        _require_launched({"launches": launches}, "main paths",
                          launches)
        launches.update(dict.fromkeys(OFF_MAIN_PATH, 0))
    except AssertionError:
        traceback.print_exc()
        print("chip_smoke: FAILED launch counts", file=sys.stderr)
        return 1
    report["launches_main_paths"] = launches
    live_launches = {name: sum(report[path]["launches"][name] for path in (
        "road4000_live", "road64k_live")) for name, _m, _a in KERNELS}
    sharded_launches = report["sharded"]["launches"]
    paper_launches = report["paper"]["launches"]
    road250k_launches = {name: report["road250k"]["launches"][name]
                         + report["road250k"]["refresh"]["launches"][name]
                         for name, _m, _a in KERNELS}
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=str))
    rows = [
        ("fw_next_reg", pick(fw_cases, "reg b=6211 n=8 (road64k piece bucket)",
                             "fw_next_reg_cuda"),
         "src/repro_torch/csrc/fw_next.cu",
         "src/repro/kernels/floyd_warshall.py:97"),
        ("fw_next_blocked", pick(fw_cases, "b=130 n=496 (frag_stage)",
                                 "fw_next_blocked_cuda"),
         "src/repro_torch/csrc/fw_next.cu",
         "src/repro/kernels/floyd_warshall.py:97"),
        ("minplus_twoside_grouped",
         pick(grouped_cases, "serve road64k cross_res (serve_cross_res)"),
         "src/repro_torch/csrc/minplus_twoside.cu",
         "src/repro/kernels/minplus_twoside.py:89"),
        ("fw_batch", pick(new_cases, "fw_batch b=1 n=64"),
         "src/repro_torch/csrc/fw_dist.cu",
         "src/repro/kernels/floyd_warshall.py:54"),
        ("fw_dist_blocked", report["sharded"]["kernel3"],
         "src/repro_torch/csrc/fw_dist.cu",
         "src/repro/kernels/floyd_warshall.py:54"),
        ("minplus_accum", pick(
            new_cases, "accum phase3 C[1792,1792] A[1792,128] B[128,1792]"),
         "src/repro_torch/csrc/minplus.cu",
         "src/repro/kernels/minplus.py:116"),
        ("minplus_accum_into", pick(
            new_cases, "into phase3 D[1728,1728] K=[576,640)"),
         "src/repro_torch/csrc/minplus.cu",
         "src/repro/kernels/minplus.py:116"),
        ("minplus_accum_panels", pick(
            new_cases, "panels D[1728,1728] K=[576,640)"),
         "src/repro_torch/csrc/minplus.cu",
         "src/repro/kernels/minplus.py:116"),
        ("minplus", pick(new_cases, "minplus [1,1712]x[1712,1712]"),
         "src/repro_torch/csrc/minplus.cu",
         "src/repro/kernels/minplus.py:64"),
        ("minplus_twoside_argmin",
         pick(slice3_cases, "argmin q=1024 S_top+1=1712"),
         "src/repro_torch/csrc/minplus_twoside_argmin.cu",
         "src/repro/kernels/minplus_twoside.py:191"),
        ("label_merge", pick(slice3_cases, "merge q=1024 W=1712"),
         "src/repro_torch/csrc/label_merge.cu",
         "src/repro/kernels/label_merge.py:66"),
        ("label_merge_rows", pick(slice3_cases, MERGE_ROWS_MAIN),
         "src/repro_torch/csrc/label_merge.cu",
         "src/repro/kernels/label_merge.py:66"),
        ("gather_minplus", pick(gather_cases, "road250k-l4 q=1024",
                                "gather_minplus_cuda"),
         "src/repro_torch/csrc/gather_minplus.cu",
         "none (XLA gathers in the reference)"),
        ("gather_minplus_twoside",
         pick(gather_cases, "road250k-l4 q=1024",
              "gather_minplus_twoside_cuda"),
         "src/repro_torch/csrc/gather_minplus.cu",
         "none (XLA gathers in the reference)"),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "live_launches": live_launches[name],
        "sharded_launches": sharded_launches[name],
        "paper_launches": paper_launches[name],
        "road250k_launches": road250k_launches[name],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": None,
        "shape": c["case"], "device_ms": c.get("device_ms"),
    } for name, c, source, replaces in rows]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
