"""The ``slab_matmul`` kernel's share of its roofline, in percent: the
least time the traced circuits' windows can take (one ``op:sv_window``
span a launch, each bounded by ``slab_work.window_bound_s``: both planes
read and written once at 3.35 TB/s, or the complex product at 495 TF32
TFLOP/s, the larger) over the device time of what those spans launched.
The width ``N`` and the window's ``d`` are the engine's, as it noted them."""

from port_bench.metrics.slab_work import device_s, notes, window_bound_s


def read(run):
    kept, seconds = notes(run), device_s(run, "sv_window")
    if not kept or seconds is None:
        return None
    windows = run.trace["per_class"]["sv_window"]["calls"]
    return 100.0 * windows * window_bound_s(kept[0]["N"], kept[0]["d"]) / seconds
