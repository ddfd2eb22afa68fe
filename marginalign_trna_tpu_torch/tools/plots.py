"""Plotting equivalents of the reference's R scripts (matplotlib, optional).

- identity_plots: identity-vs-length scatter + histograms, standing in for
  scripts/identityPlots.R (which consumed marginStats
  --printValuePerReadAlignment output).
"""
from __future__ import annotations

from typing import List, Optional


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def identity_plots(
    identities: List[float],
    read_lengths: List[int],
    output_path: str,
    title: str = "read identity",
) -> bool:
    plt = _plt()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    axes[0].scatter(read_lengths, identities, s=8, alpha=0.6)
    axes[0].set_xlabel("read length (bp)")
    axes[0].set_ylabel("identity")
    axes[0].set_title(title + " vs length")
    axes[1].hist(identities, bins=30)
    axes[1].set_xlabel("identity")
    axes[1].set_title("identity histogram")
    axes[2].hist(read_lengths, bins=30)
    axes[2].set_xlabel("read length (bp)")
    axes[2].set_title("length histogram")
    fig.tight_layout()
    fig.savefig(output_path, dpi=120)
    plt.close(fig)
    return True
