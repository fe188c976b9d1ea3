"""The traced run's arithmetic on synthetic readings: kernel names, the
port's kernels found in its sources, the idle share and its breakdown, the
labels of idle gaps, and kernel 2's bound."""
import re

import pytest

import portbench_small as small
from portbench import roofline, tracing


def test_base_name_drops_return_type_templates_and_arguments():
    assert tracing.base_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>, at::detail::Array<char*, 1> >(int, float)") \
        == "at::native::vectorized_elementwise_kernel"
    assert tracing.base_name("twoside_grouped_tiles(float const*, int)") \
        == "twoside_grouped_tiles"
    assert tracing.base_name("fw_blocked_band_kernel") == \
        "fw_blocked_band_kernel"


def test_the_ports_kernels_are_found_in_its_sources():
    pkg = small.BENCH.parent / "src" / "repro_torch"
    names = tracing.port_kernel_names(pkg)
    # one name for each __global__ of the sources, none of them an
    # attribute, and those behind nested __launch_bounds__ among them
    count = sum(len(re.findall(r"\b__global__\b", p.read_text()))
                for p in list(pkg.rglob("*.cu")) + list(pkg.rglob("*.cuh")))
    assert len(names) == count > 0
    assert not any(n.startswith("__") for n in names)
    assert {"fw_next_tile_kernel", "fw_dist_reg_kernel",
            "minplus_gemv_kernel", "label_merge_empty_kernel"} <= names
    assert set(roofline.TWOSIDE_KERNELS) <= names
    assert not any(n.startswith("at::") for n in names)


def test_kernel_names_behind_any_attribute_and_triton_kernels():
    src = """
template <int NP>
__global__ void __launch_bounds__((NP / RM) * (NP / FWT_RN))
fw_tile(const float* d) {}
__global__ void __cluster_dims__(1, S, 1) __launch_bounds__(T, 2)
  gemv (float* x) {}
__global__ void plain_kernel(int n) {}
"""
    assert tracing.cuda_kernel_names(src) == ["fw_tile", "gemv",
                                              "plain_kernel"]
    py = ("import triton\n@triton.jit\ndef lift(x_ptr):\n    pass\n"
          "@triton.autotune(configs=[])\n@triton.jit(debug=False)\n"
          "def legs(y):\n    pass\ndef host():\n    pass\n")
    assert tracing.triton_kernel_names(py) == ["lift", "legs"]


def test_summary_of_a_synthetic_trace():
    spans = tracing.Spans()
    spans.add("batch", 0.0, 10.0)
    spans.add("planner.cross_frag", 4.0, 6.0)
    ops = [("twoside_grouped_warp(float const*)", "kernel", 1.0, 2.0),
           ("void at::native::reduce_kernel<1>(int)", "kernel", 1.5, 3.0),
           ("Memcpy HtoD", "gpu_memcpy", 7.0, 7.5),
           ("void at::native::reduce_kernel<2>(int)", "kernel", 9.0, 12.0)]
    s = tracing.summarise({"t_start": 0.0, "t_stop": 10.0, "ops": ops},
                          spans, {"twoside_grouped_warp"})
    assert s["busy_s"] == pytest.approx(3.5)
    assert s["window_s"] == 10.0
    assert s["port_kernel_s"] == pytest.approx(1.0)
    assert s["torch_kernel_s"] == pytest.approx(2.5)
    assert s["breakdown"]["device_ops"][0] == [
        "at::native::reduce_kernel", pytest.approx(2.5)]
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["planner.cross_frag", pytest.approx(4.0)]
    assert [g[0] for g in gaps] == ["planner.cross_frag", "batch", "batch"]
    assert sum(g[1] for g in gaps) + s["busy_s"] == pytest.approx(10.0)


def test_spans_wrap_and_sum():
    spans = tracing.Spans()
    f = spans.wrap("unwind", lambda x: x + 1)
    assert f(1) == 2
    assert [n for n, _a, _b in spans.items] == ["unwind"]
    assert spans.seconds("unwind") >= 0.0
    assert spans.label(-1.0) == "outside spans"


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_grouped_work_counts_finite_cells_and_reached_closure_cells():
    import torch

    inf = float("inf")
    row_s = torch.tensor([[1.0, inf], [2.0, 3.0]])
    row_t = torch.tensor([[1.0], [inf]])
    d = torch.tensor([[0.0, 5.0], [inf, 1.0], [2.0, 2.0]])
    tab_s = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    tab_t = torch.tensor([[1]], dtype=torch.int32)
    gs = torch.tensor([0, 1])
    gt = torch.tensor([0, 0])
    nbytes, cells = roofline.grouped_work((row_s, gs, tab_s, d, row_t, gt,
                                           tab_t))
    # query 0: row_s[0,0] + d[0,1] + row_t[0,0]; query 1: row_t is +inf
    assert cells == 1.0
    reach = 3.0          # closure cells (0,1), (1,1), (2,1)
    assert nbytes == 4.0 * (4 + 2 + 4 + 1 + 2) + 16.0 * 2 + 4.0 * reach
