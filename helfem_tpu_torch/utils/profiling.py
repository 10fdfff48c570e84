"""Warm SCF walls and a device-time breakdown on the card (torch.profiler),
shared by chip_smoke.py and tools/profile_dia_scf.py."""

import time

import torch

__all__ = ["profile_scf"]


def profile_scf(label: str, run, rows: int = 20) -> None:
    """Warm SCF walls (min of three) of run() -> result, and the device time
    of one more SCF by kernel, from torch.profiler."""
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
