"""The trace arithmetic: the union of device intervals, idle gaps and what
the host was doing in them, kernel symbols."""

from gfbench import trace


def test_union_of_overlapping_and_nested_intervals():
    assert trace.union_length([]) == 0
    assert trace.union_length([(0, 1)]) == 1
    assert trace.union_length([(0, 2), (1, 3)]) == 3  # overlap counted once
    assert trace.union_length([(0, 10), (2, 3), (4, 5)]) == 10  # nested
    assert trace.union_length([(5, 6), (0, 1), (1, 2)]) == 3  # unsorted, touching


def test_gaps_within_a_window():
    ivs = [(1, 3), (2, 5), (7, 8), (12, 20)]
    assert trace.gaps(ivs, 0, 10) == [(0, 1), (5, 7), (8, 10)]
    assert trace.gaps([], 0, 4) == [(0, 4)]
    assert trace.gaps([(0, 4)], 0, 4) == []


def test_summary_names_idle_time_by_innermost_span():
    device = [("void probe_kernel<4>(int*)", 1, 3), ("Memcpy HtoD (Pinned -> Device)", 2, 5),
              ("void vote_kernel(int*)", 7, 8), ("outside", 20, 30)]
    host = {"gf.sample": [(0, 10)], "gf.finish_scan": [(8, 10)], "gf.scan": [(0, 8)]}
    s = trace.summarize(device, host, (0, 10))
    assert s["window"] == 10 and s["busy"] == 5
    assert s["by_symbol"] == {"probe_kernel": 2, "Memcpy HtoD (Pinned -> Device)": 3,
                              "vote_kernel": 1}
    # gaps (0,1) and (5,7) lie in gf.scan, (8,10) in gf.finish_scan
    assert s["idle"] == {"gf.scan": 3, "gf.finish_scan": 2}
    assert sum(s["idle"].values()) + s["busy"] == s["window"]


def test_kernel_symbols():
    assert trace.symbol("void probe_kernel<4, true>(int const*, unsigned char const*)") == "probe_kernel"
    assert trace.symbol("edit_distance_kernel") == "edit_distance_kernel"
    assert trace.symbol("void at::native::(anonymous namespace)::elementwise_kernel<4, "
                        "at::native::FillFunctor<int> >(int, at::native::FillFunctor<int>)") \
        == "elementwise_kernel"
    assert trace.symbol("Memset (Device)") == "Memset (Device)"


def test_device_busy_of_a_whole_trace():
    import torch
    from types import SimpleNamespace as NS

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, s, t):
        return NS(name=name, device_type=dev, time_range=NS(start=s, end=t))

    prof = NS(events=lambda: [ev("probe_kernel", cuda, 0, 2_000_000),
                              ev("Memcpy HtoD", cuda, 1_000_000, 3_000_000),
                              ev("gf.sample", cuda, 0, 9_000_000),  # a span's copy
                              ev("aten::copy_", cpu, 0, 9_000_000),
                              ev("vote_kernel", cuda, 5_000_000, 5_500_000)])
    assert trace.device_busy(prof) == 3.5
    assert trace.device_busy(NS(events=lambda: [ev("aten::copy_", cpu, 0, 1)])) is None
