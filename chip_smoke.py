#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card, ``nvcc`` and the repository checkout around this
file; without a card (or without the checkout) it exits non-zero and
prints no result.  Phases, each of which must pass:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, all in parallel) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card,
     array-equal, on integer-valued float32 inputs with ~20% +inf at
     shapes that are not tile multiples (and all-+inf blocks), timing
     kernel and plain version with CUDA events and, but for the
     per-pivot FW, the profiler's device time: the witness FW at the
     piece buckets of both main paths ([407, 8, 8], [6, 32, 32],
     [6211, 8, 8], [75, 32, 32]), the dense path's shapes, road64k's
     fragments ([130, 496, 496], out of L2) and the hierarchy's group
     closures ([6 and 3, 1024, 1024]), ragged n, tie-heavy values and
     all-+inf blocks, each shape timed for the register kernel beside
     the blocked one (n <= 64) or the blocked kernel beside the
     per-pivot one it replaced (above); the dense twoside
     contraction at the dense and top-closure shapes (S_top+1 = 1712)
     through the grouped kernel's identity tables; the distance-only FW
     (the register variant at each of its block sizes, fresh and in
     place on strided tiles, the shared-memory and per-pivot ones
     above), the (min,+) products with and without accumulation (the
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
     kernel cannot skip) and the hub-label merge (timed over input
     copies larger than the L2);
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
     2,048 seeded random hub nodes) through the same entry points, 32
     validated, ``--paths`` at one batch of 16 (all validated), then
     ``serve_one_to_all`` from 3 sources against Dijkstra and, from
     4,096 random pairs of hub nodes, the hub-gated pairs through
     ``query_hub`` (== ``query``, 32 == Dijkstra); counters zeroed just
     before and read just after; then each one-to-all source timed on
     its own (warm, synchronised, Dijkstra excluded);
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
     and the serving gap beside it are recorded: a top re-close runs
     ``first_hops`` on the host);
     counters zeroed around each run, and no kernel library built or
     loaded during one;
  9. the ``kernels`` JSON line (launches summed over the main paths of
     phases 4 and 6, the refresh epochs of phases 5 and 7 and the live
     runs of phase 8, those of phase 8 also apart as ``live_launches``;
     together they must launch both witness FW kernels, the
     grouped twoside, the label merge and the in-place accumulate, and
     never the per-pivot FW or the fresh-output accumulate; times and
     bounds from phases 2 and 7), the card's name and power limit from
     nvidia-smi, and the ``{"ok": true, ...}`` line last.

Details of every case go to ``chiprun_out/chip_smoke.json``, with the
tally of the profiler windows behind every device time; the road4000
live run's metrics snapshot and Chrome trace to
``chiprun_out/live_road4000_{metrics,trace}.json``.  The old
twoside path (rows scattered at their ids, then the first dense kernel)
is timed against the grouped kernel by ``scripts/kernel_ab.py
--twoside`` on a parent checkout.
"""
from __future__ import annotations

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
    plain version, dist and nxt array-equal, each timed in this call:
    n <= REG_MAX_N the register kernel (the main path's) and the blocked
    one, above it the blocked kernel (the main path's) and the per-pivot
    one it replaced (CUDA events; device time too, but for the per-pivot
    kernel, off the main path)."""
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
                       if n <= fw.REG_MAX_N else
                       (fw.fw_next_blocked_cuda, fw.fw_next_global_cuda)):
            got = kernel(d)
            torch.cuda.synchronize()
            dist_ok = torch.equal(got[0], want[0])
            nxt_ok = torch.equal(got[1], want[1])
            _record(out, {
                "case": label, "kernel": kernel.__name__, "b": b, "n": n,
                "kind": kind, "dist_equal": dist_ok, "nxt_equal": nxt_ok,
                "max_abs_err": _max_abs_err(got[0], want[0]),
                "ms": _time_ms(lambda: kernel(d), 2 if big else 10),
                "device_ms": (None if kernel is fw.fw_next_global_cuda
                              else _device_ms(lambda: kernel(d),
                                              2 if big else 10)),
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
    """(label, b, n, all_inf): kernel 3 (``fw_batch_cuda``) against the
    plain version.  At n <= DIST_REG_MAX_N the kernel also runs in
    place on the matrices as strided tiles of a larger tensor, as the
    blocked schedule calls it."""
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
        if n <= fw.DIST_REG_MAX_N:
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
        variant = ("reg" if n <= fw.DIST_REG_MAX_N else
                   "smem" if n <= fw.DIST_SMEM_MAX_N else "global")
        _record(out, {
            "case": label, "kernel": "fw_batch_cuda", "b": b, "n": n,
            "variant": variant, "equal": ok,
            "max_abs_err": _max_abs_err(got, want),
            "ms": _time_ms(kern, 10), "device_ms": _device_ms(kern, 10),
            "plain_ms": _time_ms(lambda: ops.fw_batch(d, force="ref"), 2),
            "bound_ms": bound, "bound_by": by}, ok)


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
           ("fw_next_global", "floyd_warshall", "fw_next_global_cuda"),
           ("minplus_twoside_grouped", "minplus_twoside",
            "minplus_twoside_grouped_cuda"),
           ("fw_batch", "floyd_warshall", "fw_batch_cuda"),
           ("minplus_accum", "minplus", "minplus_accum_cuda"),
           ("minplus_accum_into", "minplus", "minplus_accum_into_cuda"),
           ("minplus_accum_panels", "minplus", "minplus_accum_panels_cuda"),
           ("minplus", "minplus", "minplus_cuda"),
           ("minplus_twoside_argmin", "minplus_twoside",
            "minplus_twoside_argmin_cuda"),
           ("label_merge", "label_merge", "label_merge_cuda"))


#: kernel entries the main paths must not launch
OFF_MAIN_PATH = ("fw_next_global", "minplus_accum")


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
    them; times both on the gated pairs."""
    import numpy as np
    import torch
    from repro_torch.core import dijkstra
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
    print(f"  hub tier: {res}")
    if not (mask.any() and res["hub_equal_planner"]
            and res["hub_equal_dijkstra"]):
        raise AssertionError(f"hub tier: {res}")
    return res


def _main_path(graph: str, validate: int, sources=(), path_args=(),
               n_hubs: int = 0) -> dict:
    """The main path through the serve CLI's entry points (build, then
    warmup + batches + validation, then the ``--paths`` loop), then
    ``serve_one_to_all`` from ``sources`` against Dijkstra and, with
    ``n_hubs`` seeded random hub nodes, the hub tier (``_hub_check``);
    kernel launches counted in between.  After the count, each
    one-to-all source is timed on its own (``_one_to_all_ms``)."""
    import numpy as np
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import serve_one_to_all
    from repro_torch.launch import serve
    args = serve.parse_args(["--graph", graph, "--batches", "5",
                             "--batch-size", "1024", "--validate",
                             str(validate), "--device", "cuda", "--paths",
                             *path_args])
    g, ix = serve.build_host(args)
    hubs = (np.random.default_rng(11).choice(g.n, n_hubs, replace=False)
            if n_hubs else None)
    _reset_counts()
    g, dix, plan, summary = serve.build(args, hub_nodes=hubs, host=(g, ix))
    _BUILT[graph] = (g, dix)
    _HOST[graph] = (ix, plan, hubs)
    res = serve.serve(args, g, dix, summary, plan)
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


def _road64k_refresh() -> dict:
    """Two refresh epochs on phase 6's road64k index (no second build),
    through ``refresh_index`` directly: a decrease-only batch
    (``traffic_updates(frac=0.001, jam_frac=0)``), then a jam
    (``frac=0.005, jam_frac=1``).  Launch counters zeroed just before
    each refresh and read just after; each epoch == the scratch reweight
    rebuild with the same hub set, 32 answers == Dijkstra, hub answers
    on gated pairs == ``query`` (``_hub_check``), one one-to-all source
    == Dijkstra."""
    import numpy as np
    import torch
    from repro_torch.core import dijkstra
    from repro_torch.core.device_engine import (refresh_index,
                                                serve_one_to_all)
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.graph import traffic_updates
    from repro_torch.obs import trace
    g, dix = _BUILT["road64k"]
    ix, plan, hubs = _HOST["road64k"]
    rng = np.random.default_rng(12)
    tracer = trace.get_tracer()
    out = []
    for label, frac, jam in (("decrease", 0.001, 0.0), ("jam", 0.005, 1.0)):
        u, v, w = traffic_updates(g, frac, seed=10, jam_frac=jam)
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
        s, t = rng.integers(0, g2.n, 32), rng.integers(0, g2.n, 32)
        got = QueryPlanner(dix2).query(s, t)
        bad = sum(dijkstra.mismatches_oracle(
            dijkstra.pair(g2, int(a), int(b)), float(x))
            for a, b, x in zip(s, t, got))
        hub = _hub_check(g2, dix2, hubs)
        src = g2.n // 2
        o2a = serve_one_to_all(dix2, src).cpu().numpy()
        bad_o2a = int((o2a != dijkstra.sssp(g2, src).astype(
            np.float32)).sum())
        rec = {"batch": label, "update_frac": frac, "jam_frac": jam,
               "refresh_wall_s": refresh_s, **stats.as_record(),
               "stage_s": dict(stats.timings), "spans_s": spans,
               "n_eb_slots": stats.n_eb_slots,
               "scratch_reweight_s": scratch_s, "scratch_differ": differ,
               "mismatches": bad, "one_to_all_mismatches": bad_o2a,
               "hub_gated": hub["gated"], "launches": launches}
        print(f"  road64k {label} epoch: {stats.as_record()}; spans "
              f"{ {k: round(x, 4) for k, x in spans.items()} }; scratch "
              f"reweight rebuild {scratch_s:.2f}s, match={not differ}; "
              f"{bad} mismatches of 32; one-to-all {bad_o2a}; launches "
              f"{launches}")
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


#: kernels a refresh launches; serving launches none of them, so their
#: counts across a refresh call are the refresh's own even while a
#: serving thread launches its kernels beside it
REFRESH_KERNELS = ("fw_next_reg", "fw_next_blocked", "fw_next_global",
                   "fw_batch", "minplus_accum", "minplus_accum_into",
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
    built or loaded during the run (everything was loaded before it).
    Records the process's full (generation-2) garbage collections
    during the run: each stops every thread, the flusher included."""
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
    rec = live["serve_live"]
    if rec["oracle_bad"] or live["gate_failures"] or builds \
            or set(_build._LIBS) != libs:
        raise AssertionError(
            f"live at {rec['rate_qps']} qps: {rec['oracle_bad']} "
            f"mismatches, gates {live['gate_failures']}, builds {builds}, "
            f"libraries loaded {sorted(set(_build._LIBS) - libs)}")
    return live


def _live_numbers(live: dict) -> dict:
    """The numbers PERF.md keeps of one live run (with the longest full
    garbage collection inside it)."""
    rec = live["serve_live"]
    return {"gc_gen2": len(live["gc_gen2_ms"]),
            "gc_gen2_max_ms": max(live["gc_gen2_ms"], default=0.0),
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
            "label_merge", "minplus_twoside_grouped")),
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
    epoch; a top re-close runs ``first_hops`` on the host beside the
    flusher): its longest serving gap and the epoch's ``top_closure``
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
            "label_merge", "minplus_twoside_grouped")),
    }
    res["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"road64k live: {checks}")
    return res


def main() -> int:
    import torch
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

    def phase(name, fn):
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
        ("fw_batch b=2 n=240 (smem)", 2, 240, (1,)),
        ("fw_batch b=4 n=496 all-inf block", 4, 496, (1,)),
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
    phase("label_merge_kernel", lambda: _check_label_merge([
        ("merge q=1024 W=1712", 1024, 1712, None),
        ("merge q=1024 W=480", 1024, 480, None),
        ("merge q=37 W=300 one all-inf row", 37, 300, 5),
        ("merge q=33 W=299 (scalar loads)", 33, 299, 0),
    ], slice3_cases))
    phase("small_reference", _small_reference)
    phase("road4000", lambda: _main_path("road4000", 64))
    phase("road4000_levels", _level_differential)
    phase("road4000_refresh", _road4000_refresh)
    # road64k's path loop is one batch of 16: the host unwinder takes
    # ~1.7 s a path there (PERF.md)
    phase("road64k", lambda: _main_path(
        "road64k", 32, sources=(0, 31_000, 61_000),
        path_args=("--path-batches", "1", "--path-batch-size", "16"),
        n_hubs=2048))
    phase("twoside_grouped", lambda: _check_twoside_grouped(
        _grouped_cases(), grouped_cases))
    phase("road64k_refresh", _road64k_refresh)
    phase("road4000_live", _road4000_live)
    phase("road64k_live", _road64k_live)

    report["fw_cases"], report["ts_cases"] = fw_cases, ts_cases
    report["new_cases"], report["slice3_cases"] = new_cases, slice3_cases
    report["grouped_cases"] = grouped_cases
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

    def pick(cases, label, kernel=None):
        return next(c for c in cases if c["case"] == label
                    and kernel in (None, c["kernel"]))

    try:
        _require_launched(report["road4000"], "road4000",
                          ("fw_next_reg", "fw_next_blocked",
                           "minplus_twoside_grouped",
                           "minplus_twoside_argmin"))
        _require_launched(report["road64k"], "road64k",
                          ("fw_next_reg", "fw_batch", "minplus_accum_panels",
                           "minplus_accum_into", "minplus",
                           "fw_next_blocked", "minplus_twoside_grouped",
                           "minplus_twoside_argmin", "label_merge"))
        for path in ("road4000_live", "road64k_live"):
            _require_launched(report[path], path,
                              ("label_merge", "minplus_twoside_grouped",
                               "fw_next_reg", "fw_next_blocked"))
        # the main paths, the refresh epochs and the live runs (each
        # counted from zero just before it, read just after)
        launches = {name: sum(report[path]["launches"][name] for path in (
            "road4000", "road64k", "road4000_refresh", "road64k_refresh",
            "road4000_live", "road64k_live"))
            for name, _m, _a in KERNELS}
        # the per-pivot FW and the fresh-output accumulate left the main
        # paths (for the blocked FW and the in-place accumulate): timed
        # beside their replacements, never run there
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
        ("fw_next_global", pick(fw_cases, "b=130 n=496 (frag_stage)",
                                "fw_next_global_cuda"),
         "src/repro_torch/csrc/fw_next.cu",
         "src/repro/kernels/floyd_warshall.py:97"),
        ("minplus_twoside_grouped",
         pick(grouped_cases, "serve road64k cross_res (serve_cross_res)"),
         "src/repro_torch/csrc/minplus_twoside.cu",
         "src/repro/kernels/minplus_twoside.py:89"),
        ("fw_batch", pick(new_cases, "fw_batch b=1 n=64"),
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
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "live_launches": live_launches[name],
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
