"""Warm SCF walls, a device-time breakdown on the card and a kernel's device
time per call (torch.profiler, and CUDA events over calls queued behind a
sleeping kernel), shared by chip_smoke.py and the tools; and the CLIs'
--trace, a Chrome/Perfetto trace of the SCF."""

import contextlib
import time

import torch

__all__ = ["busy_wall", "device_ms", "profile_scf", "queued_ms", "trace_scf"]


@contextlib.contextmanager
def trace_scf(path: str, device):
    """A torch.profiler trace of the block, written to `path` as a Chrome
    trace JSON (chrome://tracing, ui.perfetto.dev): host operators, and on
    the card its kernels (the CLIs' --trace; helfem_tpu writes a
    jax.profiler trace there). An empty path traces nothing."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


def _kernels(events):
    """The device kernels among profiler events: device rows that are not
    the device-side span of a record_function range (a "user annotation",
    whose time is the span from its first kernel to its last, under the
    range's own name, which no kernel shares with a host row)."""
    from torch.autograd import DeviceType

    host = {e.key for e in events if e.device_type != DeviceType.CUDA}
    return [e for e in events if e.device_type == DeviceType.CUDA and e.key not in host
            and not getattr(e, "is_user_annotation", False)]


def profile_scf(label: str, run, rows: int = 20, kernels: tuple = (), ops: tuple = (),
                ranges: dict | None = None, walls: int = 3) -> dict:
    """Warm SCF walls (min of `walls`) of run() -> result, and the device time
    of one more SCF by kernel, from torch.profiler; beside the table, the
    device time and launches of each device kernel whose name contains one
    of `kernels`, which are also returned as {name: (ms, launches)}, and
    the device time and calls of each operator named in `ops` (the kernels
    it launches itself, e.g. "aten::_linalg_eigh" and its cuSOLVER kernels:
    the self time, since an operator's total also holds the profiler's own
    "Buffer Flush" and "Activity Buffer Request" rows that fall inside it),
    returned the same way; "busy" holds the device time of all kernels and
    their number. `ranges` maps a name to key prefixes of host events
    (record_function ranges, autograd's evaluate_function nodes): the total
    device time of the kernels launched inside them, returned the same
    way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(walls):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not res.converged:
        raise RuntimeError(f"warm {label} SCF did not converge")
    print(f"warm {label} SCF walls: {[round(w, 4) for w in times]} s, {res.niter} "
          f"iterations, min {min(times) / res.niter * 1e3:.2f} ms per iteration")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total"
    # device kernels only: operator rows repeat the time of their kernels
    device = _kernels(events)
    busy = sum(getattr(e, key) for e in device) * 1e-6
    print(f"profiled {label} SCF: wall {wall:.4f} s (profiler on), device busy "
          f"{busy:.4f} s = {100 * busy / wall:.1f} % of the wall")
    print(events.table(sort_by=key, row_limit=rows))
    per_kernel = {"busy": (busy * 1e3, sum(e.count for e in device))}
    for name in kernels:
        hits = [e for e in device if name in e.key]
        per_kernel[name] = (sum(getattr(e, key) for e in hits) * 1e-3, sum(e.count for e in hits))
        print(f"{label}: {name} device time {per_kernel[name][0]:.4f} ms in "
              f"{per_kernel[name][1]} launches per SCF")
    for name in ops:
        hits = [e for e in events if e.device_type != DeviceType.CUDA and e.key == name]
        per_kernel[name] = (sum(getattr(e, key) for e in hits) * 1e-3,
                            sum(e.count for e in hits))
        print(f"{label}: {name} device time {per_kernel[name][0]:.4f} ms in "
              f"{per_kernel[name][1]} calls per SCF")
    for name, prefixes in (ranges or {}).items():
        hits = [e for e in events if e.device_type != DeviceType.CUDA
                and e.key.startswith(tuple(prefixes))]
        per_kernel[name] = (sum(e.device_time_total for e in hits) * 1e-3,
                            sum(e.count for e in hits))
        print(f"{label}: {name} device time {per_kernel[name][0]:.4f} ms in "
              f"{per_kernel[name][1]} host events per SCF")
    return per_kernel


def busy_wall(run) -> tuple[float, float]:
    """(wall s, device-busy s) of one run() under torch.profiler: the wall
    with the profiler on, and the device time of all the kernels run()
    launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in _kernels(prof.key_averages())) * 1e-6
    return wall, busy


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn() in ms: the time of the kernels it
    launches, summed by torch.profiler over reps calls after one warm call,
    without the host's dispatch between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in _kernels(prof.key_averages()))
    return busy / reps * 1e-3


def queued_ms(fn, reps: int = 50) -> float | None:
    """Device time per call of fn() in ms from CUDA events around reps
    calls that the host queued while the card ran a sleeping kernel, so
    that no call waits for the host's dispatch: the launches' own gaps
    count, the host does not. None when the host did not get ahead of the
    sleep, four times lengthened."""
    fn()
    torch.cuda.synchronize()
    cycles = 200_000 * reps  # about 0.1 ms a call at the card's clock
    for _ in range(3):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(e1):
            return e1.elapsed_time(e2) / reps
        cycles *= 4
    return None
