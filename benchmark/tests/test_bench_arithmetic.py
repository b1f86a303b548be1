"""The roofline arithmetic and the trace reductions on hand-worked
cases."""

import pytest
import torch

from benchmark.harness import roofline, trace
from benchmark.harness.cell import load_module


def test_bound_takes_the_larger_of_bytes_and_operations():
    # 3.35 MB at 3.35 TB/s: 1 us; 67 MFLOP at 67 TFLOP/s: 1 us
    assert roofline.bound_s(3.35e6, 0, "float32") == pytest.approx(1e-6)
    assert roofline.bound_s(0, 67e6, "float32") == pytest.approx(1e-6)
    assert roofline.bound_s(3.35e6, 134e6, "float32") == pytest.approx(2e-6)
    assert roofline.bound_s(3.35e6, 34e6, "float64") == pytest.approx(1e-6)


def test_k2_bound_counts_inputs_and_outputs_once():
    B, C = 2, 8
    ins = (torch.zeros(B, C, dtype=torch.int32),
           torch.zeros(B, C, dtype=torch.float64),
           torch.zeros(B, C, dtype=torch.float32),
           torch.zeros(B, C, dtype=torch.bool),
           torch.zeros(B, C, dtype=torch.int64))
    outs = (torch.zeros(B, C, dtype=torch.int64),)
    moved = B * C * (4 + 8 + 4 + 1 + 8 + 8)
    ops = B * C * 3            # (C - 1).bit_length() = 3
    assert roofline.k2_bound_s(ins, outs) == pytest.approx(
        max(moved / 3.35e12, ops / 67e12))


def test_gathered_bytes_by_hand():
    B, M, lh, lv, Np = 1, 4, 2, 2, 3
    T2 = roofline.Like(torch.zeros(B, M, lh * lv, dtype=torch.float32))
    lBT = roofline.Like(torch.zeros(B, lh, lv, Np))
    lidx = torch.tensor([[0, 0, 1, 1]])
    uidx = torch.tensor([[0, 0, 1, 0]])        # pairs (0,0), (1,1), (1,0)
    nvalid = torch.tensor([2])
    got = roofline.gathered_bytes(T2, lBT, None, lidx, uidx, nvalid, torch)
    assert got == (3 * Np + 2 * M) * 4 + 8 * (2 + 2 * 4 + 1)


def ev(name, s, t):
    return trace.DeviceEvent(name, s, t)


def test_busy_union_with_overlaps_and_idle_share():
    events = [ev("a", 0.0, 1.0), ev("b", 0.5, 2.0), ev("Memcpy DtoD", 1.5,
                                                      2.5),
              ev("c", 3.0, 4.0), ev("d", 3.2, 3.4)]
    assert trace.busy_intervals(events) == [(0.0, 2.5), (3.0, 4.0)]
    assert trace.busy_seconds(events, 0.0, 3.5) == pytest.approx(3.0)
    data = trace.TraceData(instances=2, events=events, window_s=5.0,
                           kernel_bounds_s={"k2": [], "k3": []}, spans=[])
    run = type("Run", (), {"trace": data, "completed": 2,
                           "stage_times": {"ladder": 3.0, "boundary": 1.0,
                                           "search": 0.5}})()
    assert load_module("metrics", "device_idle_share").read(run) == \
        pytest.approx(30.0)
    assert load_module("metrics", "kernels_per_instance").read(run) == 2.0
    assert load_module("metrics", "ladder_s_per_instance").read(run) == 1.5
    assert load_module("metrics", "k2_merge_roofline").read(run) is None
    assert load_module("metrics", "beam_s_per_instance.device").read(run) \
        == 0.25
    assert load_module("metrics", "boundary_s_per_instance").read(run) \
        == 0.5


def test_idle_gaps_named_by_span_and_next_kernel():
    events = [ev("void f<float>(int)", 0.0, 1.0),
              ev("void ns::g(int)", 2.0, 3.0),
              ev("Memcpy HtoD (Pinned -> Device)", 3.5, 3.6)]
    gaps = trace.idle_gaps(events, 4.0, [("ladder", 0.0, 2.5),
                                         ("search", 2.5, 4.0)])
    assert gaps == [("ladder: before g", pytest.approx(1.0)),
                    ("search: before Memcpy HtoD", pytest.approx(0.5)),
                    ("search: before end", pytest.approx(0.4))]
    assert trace.top_ops(events, 2) == [("f", pytest.approx(1.0)),
                                        ("g", pytest.approx(1.0))]


@pytest.mark.parametrize("name, base", [
    ("void (anonymous namespace)::merge_block_kernel<float>(SrcArgs, "
     "Stats<float>, int)", "merge_block_kernel"),
    ("marginal_kernel(Args<double>)", "marginal_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel")])
def test_base_name(name, base):
    assert trace.base_name(name) == base
