"""The port's counterparts of the TPU probe scripts under `scripts/`, and
of `examples/op_noise.py`:

- `step_microbench` (≙ `scripts/tpu_step_microbench.py`): the components
  of one blind-rotation step, the in-loop phase generator among them;
- `gap_probe2` (≙ `scripts/gap_probe2.py`): the per-group cost of the
  multi-bit rotation with its phases hoisted and fenced;
- `vpu_probe` (≙ `scripts/vpu_probe.py`): the card's f32 and i32 chain
  rates, the fma question, matrix-product rates and a roll;
- `kernel_ab` (the port's own): designs of a kernel source (`fft.cu`,
  `rot_decomp.cu`, `mad.cu`, `phase.cu` or `probe.cu`) timed against each
  other in turns, alone and inside the path or probe that runs them, each
  a copy of the package with its own source; `mad_edges` and
  `probe_edges` hold the edge shapes that a copy is checked at;
- `op_noise` (≙ `examples/op_noise.py`): the empirical noise of
  encryption, keyswitch, CMux chains and CBS at the example's parameters,
  written as JSON (`op_noise.measure` also takes a CPU device).

Each runs on a CUDA card as `python -m spf_tpu_torch.scripts.<name>`
(without a card it raises), prints one JSON line per measurement (op_noise:
one line per op, its rows written to `--out`) and returns them from
`main()`. Importing a module runs nothing; the
functions that build a script's inputs (`step_microbench.components`,
`gap_probe2.variants`, `vpu_probe.inputs`) also take a CPU device.

Shared here, also by `chip_smoke.py`: the card's description, the pipe
model of its issue rates, and the timers.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from .. import kernels

# Compute capability 9.0, per SM and clock: four schedulers, each issuing
# one warp instruction (32 lanes) a clock, and three pipes of 16 lanes per
# scheduler that take the chains' instructions: FMA heavy (f32 add and mul,
# integer multiply IMAD, integer add VIADD), FMA lite (f32 add and mul) and
# ALU (logic, shift, compare, integer add IADD3). The two FMA pipes give
# the throughput table's 128 f32 results a clock, the heavy one alone its
# 64 integer multiplies, the ALU its 64 logic and shift results; ptxas
# emits an integer add on either pipe (VIADD and IADD3 side by side in one
# kernel, `chip_smoke.py`'s SASS counts).
SCHEDULER_LANES = 128
PIPE_LANES = 64
MIX_CLASSES = ("fma", "imad", "iadd", "alu")


def steps_per_clock(mix: dict) -> float:
    """The most element-steps of a chain one SM completes per clock, for a
    step of `mix` instructions by class: "fma" (f32 add or mul: either FMA
    pipe), "imad" (integer multiply: FMA heavy), "iadd" (integer add or
    subtract: FMA heavy or ALU), "alu" (logic, shift, compare: ALU). The
    least clocks of a step is the largest load that only a set of pipes can
    take over their lanes (the best split of the classes that may run on
    either, by max-flow min-cut), or its instructions over the issue slots."""
    if set(mix) - set(MIX_CLASSES):
        raise ValueError(f"unknown instruction classes {set(mix) - set(MIX_CLASSES)}")
    f, h, x, a = (mix.get(c, 0) for c in MIX_CLASSES)
    clocks = max(h / PIPE_LANES, a / PIPE_LANES, (f + h) / (2 * PIPE_LANES),
                 (h + x + a) / (2 * PIPE_LANES), (f + h + x + a) / SCHEDULER_LANES)
    return 1.0 / clocks


def emit(obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    return obj


def card(device: torch.device) -> dict:
    """The CUDA card's name and power limit (also as the line
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives),
    SM count and maximum SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]
    name, power, clock = (f.strip() for f in out.split(","))
    return dict(name=name, power_limit=power, nvidia_smi=f"{name}, {power}",
                sms=torch.cuda.get_device_properties(device).multi_processor_count,
                max_sm_clock_mhz=float(clock.split()[0]))


def chain_peak_per_s(ops_per_step: float, mix: dict, hw: dict) -> float:
    """The card's peak rate, in operations per second, for a chain whose
    step counts `ops_per_step` operations and issues `mix` (`card()`'s
    SMs at its maximum clock)."""
    return ops_per_step * steps_per_clock(mix) * hw["sms"] * hw["max_sm_clock_mhz"] * 1e6


def launches_since(before: dict) -> dict:
    """The kernel launches counted since `before` (a `kernels.launches()`)."""
    now = kernels.launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def device_ms(fn, copies: list, reps: int):
    """Device time of one call of fn, in ms, and the host time it took to
    issue it, in us. The calls are queued behind a spin kernel, so they
    run back to back and the events time the device, not the host's
    launch rate; the host meanwhile only issues them. They rotate through
    `copies` of the arguments, and every output is kept to the end, so
    with enough copies each call reads and writes device memory, not the
    L2 cache. Only for a few hundred launches: beyond about a thousand
    queued launches the host blocks, and its issue rate is timed too."""

    def run():
        return [fn(*copies[i % len(copies)]) for i in range(reps)]

    run()  # warm-up: the allocator caches the outputs' blocks
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000_000)
    start.record()
    t0 = time.perf_counter()
    outs = run()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    end.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(end) / reps, host_us


def profiled_kernels(fn) -> dict:
    """{kernel name: [device ms, launches]} of one call of fn, by
    torch.profiler. The device events are read from the profiler's raw
    results: building its parsed event tree takes minutes for a call of a
    million launches (a mul16 circuit), the raw events seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name().replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0][:80]
            entry = by_name.setdefault(name, [0.0, 0])
            entry[0] += e.duration_ns() / 1e6
            entry[1] += 1
    return by_name


def profiled_device_ms(fn, top: int = 8):
    """Device time of one call of fn (the sum of its kernels' device
    times, by torch.profiler) in ms, and the top kernels by device time."""
    by_name = {name: ms for name, (ms, _) in profiled_kernels(fn).items()}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), dict(ranked)


class EventsDropped(RuntimeError):
    """The profiler kept no event of a port kernel that launched."""


# profiled windows `time_calls` tries before it gives up on a kernel with
# no event kept (the profiler drops some events of short kernels: 0-27 of
# 50 a window on the H100, and once every one)
PROFILE_TRIES = 3


def per_call_device(by_name: dict, launches: dict, calls: int) -> dict:
    """Device us per call of `calls` profiled calls (`profiled_kernels`'
    {name: [ms, events]}), each port kernel's events held against the
    launches that `kernels.launches()` counted for as many calls
    (`launches`): a port kernel's time is the mean of the events the
    profiler kept times the launches, so a dropped event does not read
    low. Returns device_us, each port kernel's us a launch
    (`kernel_us`, by device function) and, where fewer events came back
    than launches, the shortfall (`events_short`). PyTorch's own kernels
    are summed as kept: nothing counts their launches. Raises where the
    profiler kept no event of a port kernel that launched."""
    want = {}
    for name, n in launches.items():
        fns = kernels.ALL[name].functions
        want[fns] = want.get(fns, 0) + n
    port_ms, kernel_us, short, seen = 0.0, {}, {}, set()
    for fns, n in want.items():
        hits = {name: v for name, v in by_name.items() if name.split("<")[0] in fns}
        seen.update(hits)
        ms, kept = sum(v[0] for v in hits.values()), sum(v[1] for v in hits.values())
        label = "/".join(fns)
        if n and not kept:
            raise EventsDropped(f"profiler kept no event of {label} ({n} launches)")
        if kept < n:
            short[label] = n - kept
        if n:
            port_ms += ms / kept * n
            kernel_us[label] = 1e3 * ms / kept
    other_ms = sum(v[0] for name, v in by_name.items() if name not in seen)
    return dict(device_us=(port_ms + other_ms) * 1e3 / calls, kernel_us=kernel_us,
                events_short=short)


def time_calls(fn, calls: int) -> dict:
    """One warm-up call, then `calls` calls issued back to back and one
    synchronise: host us per call and the kernel launches of those calls;
    then the device us per call of another `calls` calls (profiled, each
    port kernel's events held against those launches: `per_call_device`;
    profiled again, up to PROFILE_TRIES windows, while the profiler keeps
    no event of a port kernel that launched)."""
    fn()
    torch.cuda.synchronize()
    before = kernels.launches()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    launches = launches_since(before)
    for tries in range(1, PROFILE_TRIES + 1):
        by_name = profiled_kernels(lambda: [fn() for _ in range(calls)])
        try:
            device = per_call_device(by_name, launches, calls)
        except EventsDropped:
            if tries == PROFILE_TRIES:
                raise
            continue
        return dict(host_us=host_us, launches=launches, profiled_windows=tries, **device)
