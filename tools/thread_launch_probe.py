"""Launch throughput of PyTorch ops from one and from several Python
threads, each thread on a CUDA stream of its own, and what a CUDA-only
``torch.profiler`` trace costs per event.

Every thread launches ``per_thread`` in-place adds on a 16-element tensor
(a kernel of a few microseconds), so the run measures host dispatch and
the interpreter lock's hand-offs, not device work. Each case runs once to
warm up, then:

- ``untraced_s``: wall seconds of the launches, no profiler;
- ``traced_s``: the same under a CUDA-only trace;
- ``exit_s``: stopping the profiler (kineto collects the events);
- ``events_s`` / ``loop_s``: fetching the event list and reading each
  event's device type, start and duration in Python, as
  ``chip_smoke.py`` phase 11a does.

Run on a machine with a CUDA card:

    python tools/thread_launch_probe.py

One JSON line per case on stdout.
"""

from __future__ import annotations

import json
import threading
import time

import torch


def probe(n_threads: int, per_thread: int) -> dict:
    x = [torch.zeros(16, device="cuda") for _ in range(n_threads)]

    def body(i):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for _ in range(per_thread):
                x[i].add_(1.0)
        s.synchronize()

    def run():
        ts = [threading.Thread(target=body, args=(i,)) for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()

    run()
    t = time.perf_counter()
    run()
    untraced = time.perf_counter() - t
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    t = time.perf_counter()
    run()
    traced = time.perf_counter() - t
    t = time.perf_counter()
    prof.__exit__(None, None, None)
    stop = time.perf_counter() - t
    t = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    fetch = time.perf_counter() - t
    cuda = torch.autograd.DeviceType.CUDA
    t = time.perf_counter()
    device = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.device_type() == cuda)
    loop = time.perf_counter() - t
    launches = n_threads * per_thread
    return {"threads": n_threads, "launches": launches, "events": len(events),
            "device_events": len(device), "untraced_s": untraced, "traced_s": traced,
            "untraced_us_per_launch": 1e6 * untraced / launches,
            "exit_s": stop, "events_s": fetch, "loop_s": loop,
            "trace_us_per_device_event": 1e6 * (stop + fetch + loop) / max(1, len(device))}


def main() -> int:
    if not torch.cuda.is_available():
        print("thread_launch_probe: no CUDA device is available")
        return 1
    for n_threads, per_thread in ((1, 200_000), (2, 50_000), (4, 25_000)):
        print(json.dumps(probe(n_threads, per_thread)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
