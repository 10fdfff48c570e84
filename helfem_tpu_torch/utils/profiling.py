"""Warm SCF walls, a device-time breakdown on the card and a kernel's device
time per call (torch.profiler, and CUDA events over calls queued behind a
sleeping kernel), shared by chip_smoke.py and the tools; and the CLIs'
--trace, a Chrome/Perfetto trace of the SCF."""

import contextlib
import time

import torch

__all__ = ["busy_wall", "capture_warm", "device_ms", "eig_split", "profile_scf", "queued_ms",
           "trace_scf"]

K11 = "refine_eig_kernel"  # the warm eigensolve's sweeps (kernels/refine_eig.py)
EIGH = "aten::_linalg_eigh"  # the cold eigensolve: the cuSOLVER kernels it launches


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


def _busy_s(prof) -> float:
    """Device seconds of the kernels of a finished torch.profiler session,
    the rows _kernels keeps, summed over its raw events: building the
    function-event tree (key_averages) takes seconds for the tens of
    thousands of events of one SCF, this sum milliseconds. A torch whose
    raw events lack these accessors gets the tree's sum."""
    from torch.autograd import DeviceType

    try:
        events = prof.profiler.kineto_results.events()
        host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
        return 1e-9 * sum(e.duration_ns() for e in events
                          if e.device_type() == DeviceType.CUDA and e.name() not in host
                          and not e.is_user_annotation())
    except AttributeError:
        return sum(e.self_device_time_total for e in _kernels(prof.key_averages())) * 1e-6


@contextlib.contextmanager
def capture_warm(keep_inputs: bool = False):
    """Record every K11 call of the warm eigensolve (utils/linalg.py:
    eigh_warm) made inside the block: yields a list that gains one dict per
    call, {"off": its residuals per group (a device tensor, read after the
    block, so that recording adds no synchronisation)} and with
    keep_inputs "args": copies of (A, V0, npass, tau, groups), the inputs
    that chip_smoke.py and tools/warm_floor.py hold K11 against its plain
    version on."""
    from helfem_tpu_torch.utils import linalg

    calls, inner = [], linalg.refine_eig

    def recording(A, V0, npass=3, tau=1e-9, groups=1):
        out = inner(A, V0, npass, tau, groups)
        calls.append({"off": out[2], **({"args": (A.clone(), V0.clone(), npass, tau, groups)}
                                        if keep_inputs else {})})
        return out

    linalg.refine_eig = recording
    try:
        yield calls
    finally:
        linalg.refine_eig = inner


def eig_split(events) -> dict:
    """The eigensolve's device time among profiler events: {K11: (ms,
    launches), EIGH: (ms, calls)}, EIGH's the self time of the operator
    (the cuSOLVER kernels it launches)."""
    from torch.autograd import DeviceType

    k11 = [e for e in _kernels(events) if K11 in e.key]
    eigh = [e for e in events if e.device_type != DeviceType.CUDA and e.key == EIGH]
    return {name: (sum(e.self_device_time_total for e in hits) * 1e-3,
                   sum(e.count for e in hits)) for name, hits in ((K11, k11), (EIGH, eigh))}


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
    way. Every profile also splits the eigensolve: the profiled SCF's warm
    acceptances and cold solves (utils/linalg.py:warm_counts, returned
    under "warm" and "cold"), the residual of each group at each warm
    attempt (returned under "residuals", a list per K11 call), K11's
    device time and launches and aten::_linalg_eigh's (eig_split, returned
    under K11 and EIGH) and their share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from helfem_tpu_torch.utils.linalg import reset_warm_counts, warm_counts

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
    reset_warm_counts()
    with capture_warm() as calls, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    warm = dict(warm_counts)
    residuals = [c["off"].tolist() for c in calls]
    events = prof.key_averages()
    key = "self_device_time_total"
    # device kernels only: operator rows repeat the time of their kernels
    device = _kernels(events)
    busy = sum(getattr(e, key) for e in device) * 1e-6
    raw = _busy_s(prof)
    print(f"profiled {label} SCF: wall {wall:.4f} s (profiler on), device busy "
          f"{busy:.4f} s = {100 * busy / wall:.1f} % of the wall (busy_wall's sum of the raw "
          f"events {raw:.4f} s{'' if abs(raw - busy) <= 0.01 * busy else ', DISAGREES'})")
    print(events.table(sort_by=key, row_limit=rows))
    per_kernel = {"busy": (busy * 1e3, sum(e.count for e in device)), **warm,
                  "residuals": residuals}
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
    per_kernel.update(eig_split(events))
    k11, eigh = per_kernel[K11][0], per_kernel[EIGH][0]
    print(f"{label}: eigensolve per SCF: {warm['warm']} warm acceptances, {warm['cold']} cold "
          f"fallbacks of the warm path, residuals per K11 call "
          f"{[[float(f'{x:.2e}') for x in r] for r in residuals]}; "
          f"K11 {k11:.4f} ms in {per_kernel[K11][1]} launches, "
          f"eigh {eigh:.4f} ms in {per_kernel[EIGH][1]} calls, together "
          f"{100 * (k11 + eigh) / max(busy * 1e3, 1e-12):.1f} % of the busy time; the rest "
          f"{busy * 1e3 - k11 - eigh:.4f} ms")
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
    return wall, _busy_s(prof)


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
