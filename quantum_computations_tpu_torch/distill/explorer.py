"""Interactive rate-surface explorer.

Parity with reference ``fault-tolerant_.../interactive_plot.py``: a
matplotlib Slider-based 2-D explorer over precomputed rate surfaces
(the ``plot_*.dat`` schema: {"x", "y", "rates": [Z...], "labels": [...]})
with regime contours and live x/y slices.
"""

from __future__ import annotations

import json
from bisect import bisect_left

import numpy as np


def load_rate_surfaces(path: str):
    with open(path) as fh:
        data = json.load(fh)
    x = np.array(data["x"], dtype=float)
    y = np.array(data["y"], dtype=float)
    rs = [np.array(Z, dtype=float) for Z in data["rates"]]
    labels = data["labels"]
    return x, y, rs, labels


def save_rate_surfaces(path: str, x, y, rs, labels):
    """Write the plot_*.dat schema from rate surfaces (e.g. RateData.rs)."""
    data = {
        "x": np.asarray(x, dtype=float).tolist(),
        "y": np.asarray(y, dtype=float).tolist(),
        "rates": [np.asarray(Z, dtype=float).tolist() for Z in rs],
        "labels": list(labels),
    }
    with open(path, "w") as fh:
        json.dump(data, fh)


def regime_map(rs: list[np.ndarray]):
    """(Z_max, argmax ids with -1 where all rates vanish)."""
    Z = np.stack(rs)
    ids = np.argmax(Z, axis=0)
    Z = np.max(Z, axis=0)
    ids[Z == 0] = -1
    return Z, ids


def explore(path: str, label_locations=None, show: bool = True):
    """Open the interactive explorer. Returns (fig, sliders) for testing."""
    import matplotlib.pyplot as plt
    import matplotlib.gridspec as gridspec
    from matplotlib.widgets import Slider

    x, y, rs, labels = load_rate_surfaces(path)
    X, Y = np.meshgrid(x, y, indexing="ij")
    Z, ids = regime_map(rs)

    fig = plt.figure(figsize=(10, 8))
    gs = gridspec.GridSpec(3, 2, height_ratios=[2, 1, 0.2])
    main_ax = fig.add_subplot(gs[0, :])
    x_slice_ax = fig.add_subplot(gs[1, 0])
    y_slice_ax = fig.add_subplot(gs[1, 1])
    x_slider_ax = fig.add_subplot(gs[2, 0])
    y_slider_ax = fig.add_subplot(gs[2, 1])

    c = main_ax.pcolormesh(X, Y, Z, shading="auto", cmap="viridis", norm="log")
    fig.colorbar(c, ax=main_ax, label="r_distributed/r_physical")
    for rid in np.unique(ids):
        if rid < 0:
            continue
        main_ax.contour(X, Y, ids == rid, levels=[0.5], colors="black",
                        linewidths=1, corner_mask=False, linestyles="-")
    if label_locations:
        for label, loc in zip(labels, label_locations):
            if loc:
                main_ax.text(*loc, label + " regime", color="black", fontsize=12,
                             fontweight="bold", ha="left", va="center")
    main_ax.set_xlabel("r_bell/r_physical")
    main_ax.set_ylabel("Allocated memory for networking")
    main_ax.set_xscale("log")

    ix0, iy0 = len(x) // 2, len(y) // 2
    x_ind = main_ax.axvline(x[ix0], linestyle="--", color="k", linewidth=0.5)
    y_ind = main_ax.axhline(y[iy0], linestyle="--", color="k", linewidth=0.5)

    x_lines = [x_slice_ax.plot(y, Zi[ix0, :], label=lab)[0] for Zi, lab in zip(rs, labels)]
    x_slice_ax.set_xlim(y[0], y[-1])
    x_slice_ax.set_yscale("log")
    x_slice_ax.set_xlabel("Allocated memory for networking")
    x_slice_ax.set_ylabel("r_distributed / r_physical")
    x_slice_ax.legend(loc="lower right", fontsize=8)

    y_lines = [y_slice_ax.plot(x, Zi[:, iy0], label=lab)[0] for Zi, lab in zip(rs, labels)]
    y_slice_ax.set_xlim(x[0], x[-1])
    y_slice_ax.set_xscale("log")
    y_slice_ax.set_yscale("log")
    y_slice_ax.set_xlabel("r_bell / r_physical")
    y_slice_ax.set_ylabel("r_distributed / r_physical")
    y_slice_ax.legend(loc="lower right", fontsize=8)

    x_slider = Slider(x_slider_ax, "log(r_bell)", np.log10(x[0]), np.log10(x[-1]),
                      valinit=np.log10(x[ix0]), valstep=0.01)
    y_slider = Slider(y_slider_ax, "memory", y[0], y[-1], valinit=y[iy0], valstep=1)

    def x_update(_):
        idx = bisect_left(x, 10 ** x_slider.val)
        idx = min(idx, len(x) - 1)
        x_ind.set_xdata([x[idx], x[idx]])
        for line, Zi in zip(x_lines, rs):
            line.set_ydata(Zi[idx, :])
        fig.canvas.draw_idle()

    def y_update(_):
        idx = min(bisect_left(y, y_slider.val), len(y) - 1)
        y_ind.set_ydata([y[idx], y[idx]])
        for line, Zi in zip(y_lines, rs):
            line.set_ydata(Zi[:, idx])
        fig.canvas.draw_idle()

    x_slider.on_changed(x_update)
    y_slider.on_changed(y_update)
    if show:
        import matplotlib.pyplot as plt
        plt.tight_layout()
        plt.show()
    return fig, (x_slider, y_slider)


if __name__ == "__main__":
    import sys
    explore(sys.argv[1] if len(sys.argv) > 1 else "data/plot_pd.dat")
