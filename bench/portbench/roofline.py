"""Peaks of the card and the work count of kernel 2, frozen from
chip_smoke.py (``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``_bound_ms``,
``_grouped_work``) so that a change to the program cannot move them."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM bandwidth and the
# float32 rate outside the tensor cores ((min,+) has no tensor-core form)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the kernels one call of ops.minplus_twoside_grouped launches, by regime
# (kernels/minplus_twoside.py ``grouped_plan``; csrc/minplus_twoside.cu)
TWOSIDE_KERNELS = ("twoside_grouped_warp", "twoside_grouped_tiles",
                   "twoside_group_order", "twoside_min_finish")


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def grouped_work(args, cells_per_block: int = 1 << 26) -> tuple:
    """(bytes, finite cells) that ``ops.minplus_twoside_grouped(*args)``
    needs: rows, tables, groups and the answer once, and each closure cell
    some query's table pair reaches once; the (q, i, j) cells whose three
    terms are all finite (an +inf term cannot move a min).  Runs on the
    operands' device, in blocks of queries of at most ``cells_per_block``
    cells."""
    import torch

    row_s, gs, tab_s, d, row_t, gt, tab_t = args
    q, ms = row_s.shape
    mt = row_t.shape[1]
    fs = torch.isfinite(row_s).double()
    ft = torch.isfinite(row_t).double()
    ids_s, ids_t = tab_s[gs].long(), tab_t[gt].long()
    step = max(1, cells_per_block // max(1, ms * mt))
    cells = 0.0
    for i in range(0, q, step):
        blk = torch.isfinite(d[ids_s[i:i + step, :, None],
                               ids_t[i:i + step, None, :]]).double()
        cells += float(torch.einsum("qi,qij,qj->", fs[i:i + step], blk,
                                    ft[i:i + step]))
        del blk
    reach = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    for a, b in torch.unique(torch.stack([gs, gt]), dim=1).T.tolist():
        reach[tab_s[a].long()[:, None], tab_t[b].long()[None, :]] = True
    nbytes = (4.0 * (row_s.numel() + row_t.numel() + tab_s.numel()
                     + tab_t.numel() + q) + 16.0 * q
              + 4.0 * float(reach.sum()))
    return nbytes, cells


def twoside_launches(args) -> list:
    """The kernel names, in launch order, of one call on ``args``."""
    from repro_torch.kernels.minplus_twoside import grouped_plan

    row_s, _gs, tab_s, _d, row_t, _gt, tab_t = args
    regime, order, _splits = grouped_plan(
        row_s.shape[0], row_s.shape[1], row_t.shape[1], tab_s.shape[0],
        tab_t.shape[0])
    if regime == "warp":
        return ["twoside_grouped_warp"]
    return (["twoside_group_order"] if order else []) + [
        "twoside_grouped_tiles", "twoside_min_finish"]
