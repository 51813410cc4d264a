"""The metric arithmetic on synthetic records: the window's rate, the
p90, the union of the device's busy intervals, the idle share, the glue
share and the roofline sums, which stay under 100% at the kernel times
the card gave on PERF.md's shapes."""

import statistics

import pytest

from tfhe_bench import readers, run, trace
from tfhe_bench.frozen import roofline as rf


def test_rate_is_units_over_the_whole_window():
    rec = {"units": 4096, "window_s": 0.5, "latencies_s": [0.2, 0.3]}
    assert run.metric_reader("pbs_per_s").read(rec) == 8192
    assert run.metric_reader("uint_ops_per_s").read({"units": 48, "window_s": 8.0}) == 6
    assert run.metric_reader("pbs_per_s").read({"units": 1}) is None


def test_p90_is_pythons_quantile_in_ms():
    lat = [0.001 * i for i in range(1, 121)]
    got = run.metric_reader("pbs_call_p90_ms").read({"latencies_s": lat})
    assert got == pytest.approx(statistics.quantiles(lat, n=100)[89] * 1e3)
    assert 108 < got < 110
    assert run.metric_reader("pbs_call_p90_ms").read({"latencies_s": [0.1]}) is None


def _rec(ops, window):
    rec = {"device_ops": ops, "window_ns": window, "host_ops": []}
    return trace.summarise(rec)


def test_busy_is_the_union_of_overlapping_intervals_clipped_to_the_window():
    ops = [("a", 0, 100), ("b", 50, 100), ("c", 300, 50), ("d", 900, 500)]
    rec = _rec(ops, (20, 1000))
    assert rec["busy"] == [[20, 150], [300, 350], [900, 1000]]
    assert rec["busy_s"] == pytest.approx(280e-9)
    assert trace.idle_gaps(rec["busy"], rec["window_ns"]) == [(150, 300), (350, 900)]
    idle = run.metric_reader("device_idle.pbs").read(rec)
    assert idle == pytest.approx(100 * (1 - 280 / 980))
    assert run.metric_reader("device_idle.uint").read(rec) == idle


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    rec = _rec([("k", 0, 100), ("k", 400, 100)], (0, 500))
    rec["host_ops"] = [(trace.CALL_SPAN, 0, 500), ("aten::index_select", 90, 450),
                       ("cudaLaunchKernel", 300, 310)]
    b = trace.breakdown(rec)
    assert b["device_ops"] == [["k", 2e-7]]
    assert b["idle_gaps"] == [["aten::index_select", 3e-7]]


def test_glue_share_counts_kernels_that_are_not_the_ports():
    ops = [("mad_horner_kernel<2, 2>", 0, 300, ""), ("at::native::add_kernel", 300, 600, "aten::add"),
           ("Memcpy DtoH (Device -> Pageable)", 900, 100, "aten::copy_")]
    rec = _rec(ops, (0, 1000))
    assert run.metric_reader("glue_device_share.uint").read(rec) == pytest.approx(60.0)


def test_glue_is_known_by_its_launcher_not_by_its_name():
    """A kernel the program adds later, under a name no list holds, is not
    glue; a library kernel that a PyTorch operator launches is."""
    ops = [("fused_trace_switch_kernel<2>", 0, 500, ""),
           ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n", 500, 200, "aten::mm"),
           ("at::native::vectorized_elementwise_kernel<4, x>", 700, 300, "aten::sub")]
    rec = _rec(ops, (0, 1000))
    assert run.metric_reader("glue_device_share.uint").read(rec) == pytest.approx(50.0)
    bare = _rec([(n, s, d) for n, s, d, _ in ops], (0, 1000))
    assert run.metric_reader("glue_device_share.uint").read(bare) is None


class _Event:
    def __init__(self, name, cuda, start, dur, corr=0, link=0):
        self._v = (name, cuda, start, dur, corr, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[2] + self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_reduce_links_each_launch_to_its_aten_operator():
    """Runtime calls share the id space of operators: only an `aten::`
    operation names a launcher, and a launch linked to none has none."""
    events = [_Event(trace.CALL_SPAN, False, 0, 1000, 1),
              _Event("aten::add", False, 10, 50, 7), _Event("cudaLaunchKernel", False, 20, 5, 9),
              _Event("at::native::add_kernel", True, 30, 10, 9, 7),
              _Event("void (anonymous namespace)::fwd_ds_kernel<8, 1024, 1>", True, 60, 10, 0, 0),
              _Event("odd_kernel", True, 80, 10, 0, 9)]
    rec = trace.reduce(events)
    assert [(n, l) for n, _, _, l in rec["device_ops"]] == [
        ("at::native::add_kernel", "aten::add"), ("fwd_ds_kernel<8, 1024, 1>", ""), ("odd_kernel", "")]
    assert rec["window_ns"] == (0, 1000)


def test_kernel_names_and_template_arguments():
    assert rf.kernel_base("void mad_horner_kernel<2, 3>(Planes4, float*)") == "mad_horner_kernel"
    assert rf.template_args("mad_horner_kernel<2, 3>") == (2, 3)
    assert rf.template_args("accumulate_decompose_kernel") == ()
    assert rf.kernel_base("(anonymous namespace)::fwd_ds_kernel<8, 1024, 1>") == "fwd_ds_kernel"


# PERF.md section 6 (H100 80GB HBM3, 700 W): each kernel's shape, its bound
# there (ms) and the device ms a launch the card gave alone and in path 1
SECTION6 = [
    ("mad", dict(group=3, kp1=2, l=2, k=1024, b=256), 0.04516, (0.06634, 0.0627)),
    ("mad", dict(group=2, kp1=2, l=4, k=1024, b=256), 0.03459, (0.05255,)),
    ("fft", dict(p=4, k=1024, b=256), 0.01780, (0.03973, 0.0374)),
    ("fft", dict(p=2, k=1024, b=256), 0.00890, (0.02747, 0.0257)),
    ("fft", dict(p=8, k=1024, b=256), 0.03561, (0.07670,)),
    ("fft", dict(p=4, k=1024, b=256), 0.01780, (0.03906,)),
]


@pytest.mark.parametrize("kind, shape, bound_ms, times_ms", SECTION6)
def test_frozen_bounds_are_section6s_and_shares_stay_under_100(kind, shape, bound_ms, times_ms):
    bound_s = rf.mad_bound_s(**shape) if kind == "mad" else rf.fft_bound_s(**shape)
    assert bound_s * 1e3 == pytest.approx(bound_ms, rel=2e-3)
    for t in times_ms:
        share = readers.roofline(3 * bound_s, [t / 1e3] * 3)
        assert 0 < share < 100


def test_mad_roofline_sums_bounds_and_times_over_the_same_launches():
    b = dict(group=3, kp1=2, l=2, k=1024, b=2048)
    bound = rf.mad_bound_s(**b)
    ops = [("mad_horner_kernel<2, 3>", i * 10**6, int(2 * bound * 1e9)) for i in range(4)]
    ops.append(("mad_horner_kernel<2, 2>", 10**8, 10**6))  # another instance: not counted
    rec = _rec(ops, (0, 2 * 10**8))
    rec["shapes"] = {"mad_horner_g3": b}
    assert run.metric_reader("mad_horner_g3_roofline").read(rec) == pytest.approx(50, rel=1e-5)
    # per-wave widths: launches shared out over the waves in order
    rec["shapes"] = {"mad_horner_g2": dict(group=2, kp1=2, l=4, k=1024)}
    rec["device_ops"] = [("mad_horner_kernel<2, 2>", i, 1000) for i in range(6)]
    rec["counters"] = {"cbs_wave_widths": [256, 32]}
    want = 100 * 3 * (rf.mad_bound_s(2, 2, 4, 1024, 256) + rf.mad_bound_s(2, 2, 4, 1024, 32)) / 6e-6
    assert run.metric_reader("mad_horner_g2_roofline").read(rec) == pytest.approx(want)
    rec["counters"] = {"cbs_wave_widths": [256, 32, 32, 32]}  # 6 launches cannot be matched
    assert run.metric_reader("mad_horner_g2_roofline").read(rec) is None


def test_readers_find_nothing_in_an_empty_trace():
    rec = _rec([], (0, 0))
    rec.update(shapes={}, counters={}, units=0)
    for name in ("mad_horner_g3_roofline", "fft_ds_roofline", "device_idle.pbs",
                 "mad_horner_g2_roofline", "glue_device_share.uint", "waves_per_op.uint"):
        assert run.metric_reader(name).read(rec) is None


def test_waves_per_op_is_the_wave_log_over_the_operations():
    assert run.metric_reader("waves_per_op.uint").read(
        {"counters": {"waves": 536}, "units": 32}) == 16.75
