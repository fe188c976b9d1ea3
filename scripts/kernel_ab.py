#!/usr/bin/env python3
"""Time the kernels of one checkout, for before/after pairs.

    python3 scripts/kernel_ab.py --src SRC_DIR --tag NAME [--road64k]
                                 [--serve] [--twoside FILE] [--fwapsp]
                                 [--small] [--fwdist FILE] [--hub]

Needs one NVIDIA card and ``nvcc``.  Imports ``repro_torch`` from
``SRC_DIR`` (the ``src`` directory of this checkout, or of an unpacked
parent commit), so two checkouts can be timed in turns inside one chip
call (parent, change, change, parent).  On seeded integer inputs with
~20% +inf it times, with CUDA events and (for the witness argmin) the
profiler's device time:

  * ``ops.minplus_twoside_argmin`` at q = 16 and 1,024 against S+1 =
    480 and 4,614, and q = 1,024 against S_top+1 = 1,712;
  * ``ops.fw_batch_next`` (whichever variant the checkout dispatches)
    at [6, 1024, 1024], [130, 496, 496] and [1, 4613, 4613];
  * with ``--road64k``, the road64k device build at its preset's 3
    levels: ``plan.build_timings`` (frag_stage, sf_stage_l1/l2, ...);
  * with ``--serve``, the distance serving of road4000 (dense) and
    road64k (its preset's 3 levels) through the checkout's
    ``launch.serve`` entry points: the median of 20 batches of 1,024
    random pairs (host clock, each batch ending in its host copy) and
    the planner's buckets;
  * with ``--twoside FILE``, the twoside distance combine (CUDA events
    and device time, answers against the plain version): on dense rows
    (``ops.minplus_twoside``) at q = 16 and 1,024 against 480, 1,712
    and 4,614, and on the operands the road4000 and road64k planners
    hand ``ops.minplus_twoside_grouped`` for a batch of 1,024 (the
    widest call of each call site), kept in FILE.  A checkout that has
    the grouped op runs it, and captures FILE from its own builds of
    both graphs when FILE is missing (so time it first); an older one
    scatters each row at its ids (the ids gathered beforehand) and runs
    its dense ``ops.minplus_twoside``;
  * with ``--fwapsp``, the distance-only blocked APSP and its kernels
    (CUDA events and device time, each result against its plain
    version): ``ops.fw_batch`` (kernel 3) at [1, 128, 128],
    [3, 100, 100] and [1, 64, 64]; ``minplus_accum`` (kernel 4)
    at the blocked schedule's shapes for k-blocks of 128 (n = 1,711
    padded to 1,792) and of 64 (to 1,728): phase 3 and the phase-2 row
    (C = B) and column (C = A) panels, through the fresh-output entry,
    and, where the checkout has them, through the in-place entry (phase
    3) and the two-panel entry (phase 2) on views of the padded matrix;
    ``minplus`` (kernel 5) at [1,1712]x[1712,1712]
    and [1,480]x[480,480]; ``ops.fw_apsp`` at n = 1,711 and 4,661 (a
    seeded integer matrix with 99.5% +inf, as ``chip_smoke.py`` makes
    it; 4,661 is road250k's top overlay) at the checkout's default
    k-block width and, where it offers them, at 64 and 128, and at
    1,711 through the checked wrappers on views where the checkout's
    schedule has its own launch sites.  Add
    ``--road64k`` for the ``l2_fw`` build stage;
  * with ``--small``, kernels 5 and 1's small-n variant at the main
    paths' shapes (device time and CUDA events, each result against its
    plain version): ``ops.minplus`` (whichever route the checkout takes)
    at [1,480]x[480,480], [1,1712]x[1712,1712] and [1,4614]x[4614,4614]
    with B cycled out of L2 (at least 5 copies) and warm, and at
    [8,1712]x[1712,1712]; ``ops.fw_batch_next`` at the piece buckets
    [407,8,8], [6,32,32] (road4000), [6211,8,8], [75,32,32] (road64k),
    at [6211,8,8] tie-heavy and at [64,64,64] tie-heavy; then road64k's
    ``serve_one_to_all`` a source on its own (sources 0, 31,000 and
    61,000 of the preset's 3-level build: ``chip_smoke._one_to_all_ms``);
  * with ``--fwdist FILE``, kernel 3 above n = 128 (CUDA events and
    device time, each result against the plain version
    ``ops.fw_batch(force="ref")``): on road64k's fragment batch
    [130, 496, 496] (``make_build_plan``'s ``frag_adj`` of the preset's
    host index, kept in FILE: the first checkout run without FILE builds
    and saves it) the checkout's ``ops.fw_batch``, where it has the
    blocked route the schedule ``fw_blocked_into`` at k-blocks of 64 and
    128, and the witness ``ops.fw_batch_next`` (``fw_next_blocked``);
    then ``ops.fw_batch`` at b = 2, n = 200 and 240, [3, 300, 300] and
    [4, 496, 496] (seeded integers, ~20% +inf);
  * with ``--hub`` alone, the hub tier on synthetic label tables of the
    three widths the hub tier serves (W = 480 with 257 rows, 1,712 with
    2,035, 4,661 with 2,049: road4000, road64k and road250k) over 4
    nodes a row, each node its own agent, an eighth of the agents on
    the sentinel row, at q = 8, 256, 1,024 and 4,096 (the last with
    half of it (0, 0) pads, as road250k's padded hub call): the
    checkout's ``serve_hub`` (device time: every kernel it launches;
    CUDA events), its label table read as it lies (warm) and from
    copies together larger than the L2 (cold), answers against
    ``force="ref"``; the dense ``ops.label_merge`` on the two gathered
    [q, W] blocks, and ``ops.label_merge_rows`` where the checkout has
    it, warm and cold.  Only ``label_merge.cu`` is built.

Prints one JSON line tagged NAME and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE.parent))

ARGMIN = ((16, 480), (1024, 480), (16, 4614), (1024, 4614), (1024, 1712))
FW = ((6, 1024), (130, 496), (1, 4613))
TWOSIDE_DENSE = ((16, 480), (1024, 480), (1024, 1712), (16, 4614),
                 (1024, 4614))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--road64k", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--twoside")
    ap.add_argument("--fwapsp", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--fwdist")
    ap.add_argument("--hub", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    # chip_smoke puts this checkout's src first on import: the checkout
    # timed goes in front of it after
    from chip_smoke import (WINDOWS, _capture_grouped, _device_ms, _int_inf,
                            _time_ms)
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ops
    if args.hub:
        _build.build(("label_merge",))
        print(json.dumps({"tag": args.tag, "src": args.src,
                          "hub": _hub(ops), "profiler_windows": WINDOWS}),
              flush=True)
        return _print_card()
    _build.build()
    rec: dict = {"tag": args.tag, "src": args.src, "argmin": {}, "fw": {}}
    if args.fwapsp:
        rec["fwapsp"] = _fwapsp(ops)
        rec["profiler_windows"] = WINDOWS
    if args.small:
        rec["small"] = _small(ops)
        rec["profiler_windows"] = WINDOWS
    if args.fwdist:
        rec["fwdist"] = _fwdist(args.fwdist, ops)
        rec["profiler_windows"] = WINDOWS
    only = args.fwapsp or args.small or args.fwdist
    for q, k in ([] if only else ARGMIN):
        rng = np.random.default_rng(q * 37 + k)
        rows, d, rowt = (torch.from_numpy(_int_inf(s, rng)).cuda()
                         for s in ((q, k), (k, k), (q, k)))

        def fn():
            return ops.minplus_twoside_argmin(rows, d, rowt)
        rec["argmin"][f"q={q} k={k}"] = {"ms": _time_ms(fn, 10),
                                         "device_ms": _device_ms(fn, 10)}
    for b, n in ([] if only else FW):
        rng = np.random.default_rng(b * 7919 + n)
        d = torch.from_numpy(_int_inf((b, n, n), rng)).cuda()
        rec["fw"][f"b={b} n={n}"] = _time_ms(lambda: ops.fw_batch_next(d),
                                             2)
    if args.road64k:
        from repro_torch.core.device_engine import build_device_index_with_plan
        from repro_torch.core.graph import road_like
        from repro_torch.core.supergraph import build_index
        from repro_torch.data.roads import road_preset
        preset = road_preset("road64k")
        ix = build_index(road_like(preset.nodes, seed=0))
        _dix, plan = build_device_index_with_plan(
            ix, device="cuda", hierarchy_levels=preset.hierarchy)
        rec["road64k_build_timings"] = dict(plan.build_timings)
    grouped = hasattr(ops, "minplus_twoside_grouped")
    capture = bool(args.twoside and grouped
                   and not Path(args.twoside).exists())
    if args.serve or capture:
        from repro_torch.launch import serve
        rec["serve"], captured = {}, {}
        for graph in ("road4000", "road64k"):
            sargs = serve.parse_args(["--graph", graph, "--batches", "20",
                                      "--batch-size", "1024", "--validate",
                                      "0", "--device", "cuda"])
            g, dix, plan, summary = serve.build(sargs)
            if args.serve:
                res = serve.serve(sargs, g, dix, summary, plan)
                rec["serve"][graph] = {k: res[k] for k in (
                    "median_batch_ms", "us_per_query", "buckets",
                    "peak_device_mb")}
            if capture:
                for site, ops_args in _capture_grouped(dix, g.n, 21).items():
                    captured[f"{graph} {site}"] = tuple(a.cpu()
                                                        for a in ops_args)
            del dix
            torch.cuda.empty_cache()
        if capture:
            torch.save(captured, args.twoside)
    if args.twoside:
        rec["twoside"] = _twoside(args.twoside, grouped, ops)
        rec["profiler_windows"] = WINDOWS
    print(json.dumps(rec), flush=True)
    return _print_card()


def _print_card() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


#: (W, label rows) of the hub tables ``--hub`` times: road4000's live
#: tier, road64k's and road250k's
HUB_TABLES = ((480, 257), (1712, 2035), (4661, 2049))
HUB_Q = (8, 256, 1024, 4096)


def _hub_index(w, h, rng):
    """A synthetic index with what ``serve_hub`` reads: label table
    [h, w] (integers, ~10% +inf, the all-+inf sentinel last row) over
    4h nodes, each node its own agent in a fragment, ``hub_of_agent``
    uniform over the rows with an eighth of the agents on the sentinel,
    integer ``dist_to_agent``."""
    import types

    import numpy as np
    import torch
    from chip_smoke import _int_inf
    n = 4 * h
    rows = _int_inf((h, w), rng, 0.1)
    rows[h - 1] = np.inf
    hub = rng.integers(0, h, n)
    hub[rng.random(n) < 0.125] = h - 1
    host = {"agent_of": np.arange(n), "frag_of": np.zeros(n),
            "hub_of_agent": hub,
            "dist_to_agent": rng.integers(0, 50, n).astype(np.float32)}
    return types.SimpleNamespace(
        hub_rows=torch.from_numpy(rows).cuda(),
        **{k: torch.from_numpy(v.astype(np.float32 if k == "dist_to_agent"
                                        else np.int32)).cuda()
           for k, v in host.items()})


def _hub(ops) -> dict:
    """The ``--hub`` readings of this checkout (see the module note):
    {"W=w q=q": {"equal", "serve_hub": {...}, "merge_dense": {...}[,
    "merge_rows": {...}]}}, each with warm and cold device ms."""
    import copy
    import functools

    import numpy as np
    import torch
    from chip_smoke import _COLD_BYTES, _device_ms, _time_ms
    from repro_torch.core.device_engine import serve_hub
    out = {}

    def cycled(fn, variants):
        turn = iter(range(1 << 30))
        return lambda: fn(*variants[next(turn) % len(variants)])
    for w, h in HUB_TABLES:
        rng = np.random.default_rng(w)
        dix = _hub_index(w, h, rng)
        n_cp = max(2, -(-_COLD_BYTES // (4 * dix.hub_rows.numel())))
        dixs = [copy.copy(dix) for _ in range(n_cp)]
        for d in dixs:
            d.hub_rows = dix.hub_rows.clone()
        for q in HUB_Q:
            nodes = dix.agent_of.shape[0]
            s, t = (torch.from_numpy(rng.integers(0, nodes, q)).cuda()
                    for _ in range(2))
            if q == 4096:
                s[q // 2:], t[q // 2:] = 0, 0
            got = serve_hub(dix, s, t)
            want = serve_hub(dix, s, t, force="ref")
            ids = [dix.hub_of_agent[dix.agent_of[x].long()] for x in (s, t)]
            ls, lt = (dix.hub_rows[i.long()] for i in ids)
            n_dense = max(2, -(-_COLD_BYTES // (8 * ls.numel())))
            blocks = [(ls.clone(), lt.clone()) for _ in range(n_dense)]
            hot = functools.partial(serve_hub, dix, s, t)
            cold = cycled(serve_hub, [(d, s, t) for d in dixs])
            rec = {"equal": bool(torch.equal(got, want)),
                   "copies": n_cp, "serve_hub": {
                       "device_ms": _device_ms(hot, 20),
                       "cold_device_ms": _device_ms(cold, 20),
                       "ms": _time_ms(hot, 20),
                       "cold_ms": _time_ms(cold, 20)},
                   "merge_dense": {
                       "device_ms": _device_ms(
                           functools.partial(ops.label_merge, ls, lt), 20),
                       "cold_device_ms": _device_ms(
                           cycled(ops.label_merge, blocks), 20)}}
            if hasattr(ops, "label_merge_rows"):
                rec["merge_rows"] = {
                    "device_ms": _device_ms(functools.partial(
                        ops.label_merge_rows, dix.hub_rows, *ids), 20),
                    "cold_device_ms": _device_ms(cycled(
                        ops.label_merge_rows,
                        [(d.hub_rows, *ids) for d in dixs]), 20)}
            out[f"W={w} q={q}"] = rec
            print(f"  hub W={w} q={q}: {rec}", flush=True)
            del blocks, ls, lt
        del dix, dixs
        torch.cuda.empty_cache()
    return out


def _fwapsp(ops) -> dict:
    """The ``--fwapsp`` readings of this checkout (see the module
    note): {label: {"ms", "device_ms", "equal"}}."""
    import functools

    import numpy as np
    import torch
    from chip_smoke import _device_ms, _int_inf, _time_ms
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import minplus as mp
    out = {}

    def time(label, fn, want, reps=20, dev_reps=20):
        got = fn()
        torch.cuda.synchronize()
        out[label] = {"equal": (None if want is None
                                else bool(torch.equal(got, want))),
                      "ms": _time_ms(fn, reps),
                      "device_ms": _device_ms(fn, dev_reps)}
        print(f"  {label}: {out[label]}", flush=True)

    for b, n in ((1, 128), (3, 100)):
        rng = np.random.default_rng(b * 7907 + n)
        d = torch.from_numpy(_int_inf((b, n, n), rng)).cuda()
        want = ops.fw_batch(d, force="ref")
        time(f"fw_batch b={b} n={n}", functools.partial(fw.fw_batch_cuda, d),
             want)
    d = torch.from_numpy(_int_inf((1, 64, 64), np.random.default_rng(64))
                         ).cuda()
    time("fw_batch b=1 n=64", functools.partial(fw.fw_batch_cuda, d),
         ops.fw_batch(d, force="ref"))
    for np_, blk, s in ((1792, 128, 512), (1728, 64, 576)):
        rng = np.random.default_rng(np_)
        x = torch.from_numpy(_int_inf((np_, np_), rng)).cuda()
        e = s + blk
        x[s:e, s:e] = ops.fw_batch(x[None, s:e, s:e].contiguous())[0]
        dkk = x[s:e, s:e].contiguous()
        row, col = x[s:e].contiguous(), x[:, s:e].contiguous()
        tag = f"D[{np_}] K=[{s},{e})"
        for label, c, a, b in (("phase3", x, col, row),
                               ("phase2 row", row, dkk, row),
                               ("phase2 col", col, col, dkk)):
            time(f"minplus_accum {label} {tag}",
                 functools.partial(mp.minplus_accum_cuda, c, a, b),
                 ops.minplus_accum(c, a, b, force="ref"))
        if not hasattr(mp, "minplus_accum_panels_cuda"):
            continue

        def views(p):
            return p[s:e, s:e], p[s:e], p[:, s:e]
        got, want = x.clone(), x.clone()
        gk, gr, gc = views(got)
        wk, wr, wc = views(want)
        ops.minplus_accum_into(want, wc, wr, skip_rows=(s, e),
                               skip_cols=(s, e), force="ref")
        time(f"minplus_accum_into phase3 {tag}", functools.partial(
            mp.minplus_accum_into_cuda, got, gc, gr, skip_rows=(s, e),
            skip_cols=(s, e)), want)
        got, want = x.clone(), x.clone()
        gk, gr, gc = views(got)
        wk, wr, wc = views(want)
        ops.minplus_accum_panels((wr, wk, wr), (wc, wc, wk),
                                 skip_cols=(s, e), skip_rows=(s, e),
                                 force="ref")

        def panels(gk=gk, gr=gr, gc=gc):
            mp.minplus_accum_panels_cuda((gr, gk, gr), (gc, gc, gk),
                                         skip_cols=(s, e), skip_rows=(s, e))
            return got
        time(f"minplus_accum_panels phase2 {tag}", panels, want)
    for n in (1712, 480):
        rng = np.random.default_rng(n)
        a = torch.from_numpy(_int_inf((1, n), rng)).cuda()
        b = torch.from_numpy(_int_inf((n, n), rng)).cuda()
        time(f"minplus [1,{n}]x[{n},{n}]",
             functools.partial(mp.minplus_cuda, a, b),
             ops.minplus(a, b, force="ref"))
    blocks = (None, 64, 128) if hasattr(fw, "apsp_block") else (None,)
    for n in (1711, 4661):
        rng = np.random.default_rng(n + 128)
        d = torch.from_numpy(_int_inf((n, n), rng, 0.995)).cuda()
        want = ops.fw_apsp(d, force="ref")
        for blk in blocks:
            kw = {} if blk is None else {"block": blk}
            time(f"fw_apsp n={n} block={blk or 'default'}",
                 functools.partial(ops.fw_apsp, d, **kw), want,
                 reps=5 if n < 2000 else 2, dev_reps=3 if n < 2000 else 1)
        if n < 2000 and hasattr(fw, "blocked_steps"):
            time(f"fw_apsp n={n} block=default through the checked wrappers",
                 functools.partial(_apsp_on_views, fw, ops, d), want,
                 reps=5, dev_reps=3)
    return out


def _small(ops) -> dict:
    """The ``--small`` readings of this checkout (see the module note):
    {label: {"equal", "ms", "device_ms"[, "warm_device_ms"]}}, and the
    road64k one-to-all times under "road64k one-to-all"."""
    import functools

    import numpy as np
    import torch
    from chip_smoke import (_cold_minplus, _device_ms, _fw_input, _int_inf,
                            _one_to_all_ms, _time_ms)
    out = {}

    def ints(shape, rng):
        return torch.from_numpy(_int_inf(shape, rng)).cuda()
    for m, n, cold in ((1, 480, True), (1, 1712, True), (1, 4614, True),
                       (8, 1712, False)):
        rng = np.random.default_rng(m * 31 + n)
        a, b = ints((m, n), rng), ints((n, n), rng)
        want = ops.minplus(a, b, force="ref")
        got = ops.minplus(a, b)
        torch.cuda.synchronize()
        rec = {"equal": bool(torch.equal(got, want))}
        fn = functools.partial(ops.minplus, a, b)
        if cold:
            rec["warm_device_ms"] = _device_ms(fn, 50)
            fn, rec["copies"] = _cold_minplus(ops.minplus, a, b)
        rec.update(ms=_time_ms(fn, 50), device_ms=_device_ms(fn, 50))
        out[f"minplus [{m},{n}]x[{n},{n}]"] = rec
        print(f"  minplus [{m},{n}]: {rec}", flush=True)
        del a, b, fn
        torch.cuda.empty_cache()
    for b, n, kind in ((407, 8, "ragged"), (6, 32, "ragged"),
                       (6211, 8, "ragged"), (75, 32, "ragged"),
                       (6211, 8, "ties"), (64, 64, "ties")):
        d = _fw_input(b, n, kind, ())
        want = ops.fw_batch_next(d, force="ref")
        got = ops.fw_batch_next(d)
        torch.cuda.synchronize()
        rec = {"equal": bool(torch.equal(got[0], want[0])
                             and torch.equal(got[1], want[1])),
               "ms": _time_ms(lambda: ops.fw_batch_next(d), 50),
               "device_ms": _device_ms(lambda: ops.fw_batch_next(d), 50)}
        out[f"fw_batch_next b={b} n={n} {kind}"] = rec
        print(f"  fw_batch_next b={b} n={n} {kind}: {rec}", flush=True)
    from repro_torch.core.device_engine import build_device_index_with_plan
    from repro_torch.core.graph import road_like
    from repro_torch.core.supergraph import build_index
    from repro_torch.data.roads import road_preset
    preset = road_preset("road64k")
    dix, _plan = build_device_index_with_plan(
        build_index(road_like(preset.nodes, seed=0)), device="cuda",
        hierarchy_levels=preset.hierarchy)
    sources = (0, 31_000, 61_000)
    out["road64k one-to-all"] = {"sources": list(sources),
                                 **_one_to_all_ms(dix, sources)}
    print(f"  road64k one-to-all: {out['road64k one-to-all']}", flush=True)
    return out


def _road64k_fragments(path: str):
    """road64k's fragment batch [k, maxf, maxf] (float32 on the card),
    from ``path`` or, when it is missing, from the preset's host index
    (``make_build_plan``), saved there."""
    import torch
    if not Path(path).exists():
        from repro_torch.core.device_engine import make_build_plan
        from repro_torch.core.graph import road_like
        from repro_torch.core.supergraph import build_index
        from repro_torch.data.roads import road_preset
        plan = make_build_plan(build_index(road_like(
            road_preset("road64k").nodes, seed=0)))
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(torch.from_numpy(plan.frag_adj), path)
    return torch.load(path).cuda()


def _fwdist(path: str, ops) -> dict:
    """The ``--fwdist`` readings of this checkout (see the module note):
    {label: {"equal", "ms", "device_ms"}}, and the fragment batch's
    shape, +inf share and rows with a finite off-diagonal entry."""
    import functools

    import numpy as np
    import torch
    from chip_smoke import _device_ms, _int_inf, _time_ms
    from repro_torch.kernels import floyd_warshall as fw
    out = {}

    def time(label, fn, want, reps=5, dev_reps=3):
        got = fn()
        torch.cuda.synchronize()
        out[label] = {"equal": bool(torch.equal(got, want)),
                      "ms": _time_ms(fn, reps),
                      "device_ms": _device_ms(fn, dev_reps)}
        print(f"  {label}: {out[label]}", flush=True)

    adj = _road64k_fragments(path)
    b, n = adj.shape[0], adj.shape[1]
    want = ops.fw_batch(adj, force="ref")
    off = ~torch.eye(n, dtype=torch.bool, device=adj.device)
    live = (torch.isfinite(adj) & off).any(dim=2).sum(dim=1)
    out["fragments"] = {
        "shape": [b, n, n], "inf_share": float(torch.isinf(adj).double()
                                               .mean()),
        "result_inf_share": float(torch.isinf(want).double().mean()),
        "live_rows": live.tolist()}
    tag = f"b={b} n={n}"
    time(f"ops.fw_batch {tag}", functools.partial(ops.fw_batch, adj), want)
    scratch = None
    if hasattr(fw, "fw_blocked_into"):
        scratch = torch.empty_like(adj)

        def blocked(block):
            scratch.copy_(adj)
            return fw.fw_blocked_into(scratch, block=block)
        for block in (64, 128):
            time(f"fw_blocked_into block={block} {tag}",
                 functools.partial(blocked, block), want)
    time(f"ops.fw_batch_next (fw_next_blocked) {tag}",
         lambda: ops.fw_batch_next(adj)[0], want, 2, 1)
    del adj, want, scratch
    torch.cuda.empty_cache()
    for b, n in ((2, 200), (2, 240), (3, 300), (4, 496)):
        rng = np.random.default_rng(b * 7907 + n)
        d = torch.from_numpy(_int_inf((b, n, n), rng)).cuda()
        want = ops.fw_batch(d, force="ref")
        time(f"ops.fw_batch b={b} n={n}", functools.partial(ops.fw_batch, d),
             want, 20, 10)
    return out


def _apsp_on_views(fw, ops, d):
    """``fw.fw_blocked``'s schedule on the card through the checked
    wrappers on tensor views (``ops``, as its CPU branch calls them),
    not through the launch sites: what the packing and checks of each
    launch cost on the host."""
    import torch
    n = d.shape[0]
    block = fw.apsp_block(n)
    np_ = -(-n // block) * block
    pad = torch.full((np_, np_), float("inf"), device=d.device)
    pad[:n, :n] = d
    pad.fill_diagonal_(0.0)

    def view(w):
        return pad[w[0]:w[0] + w[2], w[1]:w[1] + w[3]]
    for step in fw.blocked_steps(np_, block):
        if step[0] == "fw":
            tile = view(step[1])[None]
            ops.fw_batch(tile, out=tile)
        elif step[0] == "p2":
            _, row, skip_c, col, skip_r = step
            ops.minplus_accum_panels(tuple(map(view, row)),
                                     tuple(map(view, col)),
                                     skip_cols=skip_c, skip_rows=skip_r)
        else:
            _, c, a, b, skip_r, skip_c = step
            ops.minplus_accum_into(view(c), view(a), view(b),
                                   skip_rows=skip_r, skip_cols=skip_c)
    return pad[:n, :n].contiguous()


def _scatter_combine(ops, de, row_s, ids_s, d, row_t, ids_t):
    """The combine before the grouped op: each row scattered at its ids,
    then the dense ``ops.minplus_twoside``."""
    return ops.minplus_twoside(de._scatter_rows(row_s, ids_s, d.shape[0]), d,
                               de._scatter_rows(row_t, ids_t, d.shape[1]))


def _twoside(path: str, grouped: bool, ops) -> dict:
    """The twoside distance combine of this checkout, timed on dense rows
    and on the captured serve operands in ``path`` (see the module
    note)."""
    import functools

    import numpy as np
    import torch
    from chip_smoke import _device_ms, _int_inf, _time_ms
    from repro_torch.core import device_engine as de
    out = {}
    cases = []
    for q, k in TWOSIDE_DENSE:
        rng = np.random.default_rng(q * 31 + k)
        dense = tuple(torch.from_numpy(_int_inf(s, rng)).cuda()
                      for s in ((q, k), (k, k), (q, k)))
        cases.append((f"dense q={q} k={k}",
                      functools.partial(ops.minplus_twoside, *dense), dense))
    for label, cpu_args in torch.load(path).items():
        args = tuple(a.cuda() for a in cpu_args)
        row_s, gs, tab_s, d, row_t, gt, tab_t = args
        ids_s, ids_t = tab_s[gs].long(), tab_t[gt].long()
        scattered = (de._scatter_rows(row_s, ids_s, d.shape[0]), d,
                     de._scatter_rows(row_t, ids_t, d.shape[1]))
        if grouped:
            fn = functools.partial(ops.minplus_twoside_grouped, *args)
        else:
            fn = functools.partial(_scatter_combine, ops, de, row_s, ids_s,
                                   d, row_t, ids_t)
        cases.append((label, fn, scattered))
    for label, fn, dense in cases:
        got = fn()
        want = ops.minplus_twoside(*dense, force="ref")
        out[label] = {"equal": bool(torch.equal(got, want)),
                      "q": dense[0].shape[0],
                      "ms": _time_ms(fn, 20), "device_ms": _device_ms(fn, 20)}
    return out


if __name__ == "__main__":
    sys.exit(main())
