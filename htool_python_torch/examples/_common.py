"""What the examples share: the relative error, the command line, and
saving a picture beside the script (matplotlib only there)."""

from __future__ import annotations

import argparse
import os

import numpy as np


def rel_err(y, y_ref) -> float:
    return float(np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref))


def cli(doc: str, argv=None) -> argparse.Namespace:
    """--cpu (the device is CUDA otherwise), --partitions, --show."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--partitions", type=int, default=2,
                    help="partitions of the distributed examples (default 2)")
    ap.add_argument("--show", action="store_true",
                    help="show the picture instead of saving a PNG")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else None
    return args


def figure(show: bool, size=(9, 4.5)):
    """A new matplotlib figure (the Agg backend unless it is shown)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt.figure(figsize=size)


def finish_plot(fig, script: str, show: bool) -> None:
    """Show the figure, or save it as <script>.png beside the script."""
    import matplotlib.pyplot as plt

    if show:
        plt.show()
    else:
        out = os.path.splitext(os.path.abspath(script))[0] + ".png"
        fig.savefig(out, dpi=110)
        print(f"plot saved to {out}")
    plt.close(fig)
