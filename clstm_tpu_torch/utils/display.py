"""Live training visualization (port of clstm_tpu/utils/display.py).

Reference: pymulti.h (≈L1-150, unverified) — a ZMQ ``PyServer`` bridge
streaming arrays to an external Python plot process, enabled by env
``display_every``. The trainer is Python, so no IPC is needed: a
``Display`` collects scalar curves (and, given them, a line's frame
posteriors and image) on the host and renders a PNG dashboard with
matplotlib's headless Agg back end. ``display_every=N`` in clstmocrtrain
writes ``<save_name>-display.png`` every N trials. Without matplotlib it
does nothing (``render`` returns None).

Every value a Display holds is a host number: the trainer hands it the
losses its deferred reports (utils/config.py::HostCopy) already copied
back, so drawing never waits for the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    HAVE_MPL = True
except ImportError:  # pragma: no cover
    HAVE_MPL = False


class Display:
    """Collects training curves; renders a dashboard PNG on demand."""

    def __init__(self, path: str = "display.png"):
        self.path = path
        self.trials: list = []
        self.losses: list = []
        self.test_trials: list = []
        self.test_errs: list = []

    def add_loss(self, trial: int, loss: float) -> None:
        self.trials.append(trial)
        self.losses.append(loss)

    def add_test_err(self, trial: int, err: float) -> None:
        self.test_trials.append(trial)
        self.test_errs.append(err)

    def render(self, frame_probs: Optional[np.ndarray] = None,
               image: Optional[np.ndarray] = None) -> Optional[str]:
        """Write the dashboard PNG; returns the path (None without
        matplotlib).

        frame_probs: optional [T, C] posteriors of the last reported line
        (the reference plots these per-class curves); image: the line
        image. Both are host arrays."""
        if not HAVE_MPL:
            return None
        n = 1 + (frame_probs is not None) + (image is not None)
        fig, axes = plt.subplots(n, 1, figsize=(10, 3 * n), squeeze=False)
        ax = axes[0][0]
        if self.trials:
            ax.plot(self.trials, self.losses, lw=0.8, label="loss")
        if self.test_trials:
            ax2 = ax.twinx()
            ax2.plot(self.test_trials, self.test_errs, "r.-", label="test CER")
            ax2.set_ylabel("test CER")
        ax.set_xlabel("trial")
        ax.set_ylabel("loss")
        ax.set_title("training")
        i = 1
        if image is not None:
            axes[i][0].imshow(image, cmap="gray", aspect="auto")
            axes[i][0].set_title("last line")
            i += 1
        if frame_probs is not None:
            axes[i][0].plot(frame_probs, lw=0.5)
            axes[i][0].set_title("frame posteriors")
        fig.tight_layout()
        fig.savefig(self.path, dpi=80)
        plt.close(fig)
        return self.path
