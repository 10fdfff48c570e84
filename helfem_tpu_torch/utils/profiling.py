"""Warm SCF walls, a device-time breakdown on the card and a kernel's device
time per call (torch.profiler), shared by chip_smoke.py and the tools."""

import time

import torch

__all__ = ["device_ms", "profile_scf"]


def profile_scf(label: str, run, rows: int = 20, kernels: tuple = (), ops: tuple = ()) -> dict:
    """Warm SCF walls (min of three) of run() -> result, and the device time
    of one more SCF by kernel, from torch.profiler; beside the table, the
    device time and launches of each device kernel whose name contains one
    of `kernels`, which are also returned as {name: (ms, launches)}, and
    the device time and calls of each operator named in `ops` (the kernels
    it launches itself, e.g. "aten::_linalg_eigh" and its cuSOLVER kernels:
    the self time, since an operator's total also holds the profiler's own
    "Buffer Flush" and "Activity Buffer Request" rows that fall inside it),
    returned the same way; "busy" holds the device time of all kernels and
    their number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not res.converged:
        raise RuntimeError(f"warm {label} SCF did not converge")
    print(f"warm {label} SCF walls: {[round(w, 4) for w in walls]} s, {res.niter} "
          f"iterations, min {min(walls) / res.niter * 1e3:.2f} ms per iteration")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total"
    # device kernels only: operator rows repeat the time of their kernels
    busy = sum(getattr(e, key) for e in events if e.device_type == DeviceType.CUDA) * 1e-6
    print(f"profiled {label} SCF: wall {wall:.4f} s (profiler on), device busy "
          f"{busy:.4f} s = {100 * busy / wall:.1f} % of the wall")
    print(events.table(sort_by=key, row_limit=rows))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
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
    return per_kernel


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn() in ms: the time of the kernels it
    launches, summed by torch.profiler over reps calls after one warm call,
    without the host's dispatch between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / reps * 1e-3
