"""Run-directory reporting: ``summary.csv`` and its per-column plots.

A copy of ``update_summary`` and ``plot_csv`` of
``deepfake_detection_tpu/utils/summary.py`` (the port imports nothing of
that package): one row an epoch, ``epoch`` then ``train_*`` and
``eval_*`` columns; the header is written only when the caller says so
(the runner: when the file does not exist yet, so a resumed run appends
no second header).  Plots need matplotlib, which is imported lazily; a
missing matplotlib (the card's machine has none) or a failed plot is
swallowed, as the reference's bare ``try``.
"""

from __future__ import annotations

import csv
import os
from collections import OrderedDict
from typing import Dict, Optional

__all__ = ["update_summary", "plot_csv"]


def _plot_figure(x_data, y_data, name: str, plots_dir: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.set_title(name, color="red")
    ax.set_xlabel("epoch", fontsize=15, color="gray")
    ax.set_ylabel(name, fontsize=15, color="gray")
    ax.plot(x_data, y_data, "ro-")
    ax.grid(True)
    try:
        plt.savefig(os.path.join(plots_dir, f"{name}.jpg"))
    except Exception:  # noqa: BLE001 - plots are best-effort
        pass
    plt.close(fig)


def plot_csv(filename: str, plots_dir: str) -> None:
    """One plot per numeric column of ``filename`` against ``epoch``."""
    os.makedirs(plots_dir, exist_ok=True)
    with open(filename) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return
    x = [float(r["epoch"]) for r in rows]
    for column in rows[0].keys():
        if column == "epoch":
            continue
        try:
            y = [float(r[column]) for r in rows]
        except (TypeError, ValueError):
            continue
        _plot_figure(x, y, column, plots_dir)


def update_summary(epoch: int, train_metrics: Dict, eval_metrics: Dict,
                   filename: str, plots_dir: Optional[str] = None,
                   write_header: bool = False) -> None:
    """Append one epoch's row to ``filename`` and refresh the plots."""
    rowd = OrderedDict(epoch=epoch)
    rowd.update([("train_" + k, v) for k, v in train_metrics.items()])
    rowd.update([("eval_" + k, v) for k, v in eval_metrics.items()])
    with open(filename, "a") as cf:
        dw = csv.DictWriter(cf, fieldnames=rowd.keys())
        if write_header:
            dw.writeheader()
        dw.writerow(rowd)
    if plots_dir:
        try:
            plot_csv(filename, plots_dir)
        except Exception:  # noqa: BLE001 - plots are best-effort
            pass
