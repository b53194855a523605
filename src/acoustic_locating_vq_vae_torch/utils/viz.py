"""Visualization (visualization.py:6-15 of the reference), matplotlib-gated.

Counterpart of ``acoustic_locating_vq_vae_tpu/utils/viz.py:25-57``, the same
contract: 1-D (or single-row) inputs render as a magnitude line plot, 2-D as
a dB image (``dsp.power_to_db``) with the low frequencies at the bottom;
an existing-axis target, a colorbar, and a one-row multi-panel helper for
side-by-side input / reconstruction comparison. Tensors are taken on any
device and brought to the host here. matplotlib is imported inside the
functions only, so the package imports without it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_spectrogram", "plot_spectrogram_grid"]

_IMAGE_STYLE = dict(origin="lower", aspect="auto", interpolation="nearest")


def plot_spectrogram(spectrogram, title=None, ylabel="freq_bin", ax=None, colorbar=False):
    """Render one spectrogram (or 1-D signal) onto ``ax`` and return the axis."""
    from matplotlib import pyplot as plt

    from ..dsp import power_to_db  # here: dsp imports utils.device, so utils may not import dsp at its import

    arr = torch.as_tensor(spectrogram).detach().cpu()
    if ax is None:
        _, ax = plt.subplots(1, 1)
    if title is not None:
        ax.set_title(title)
    ax.set_ylabel(ylabel)

    if arr.ndim == 1 or arr.shape[0] == 1:
        ax.plot(np.abs(arr.numpy()).reshape(-1))
        return ax

    image = ax.imshow(power_to_db(arr).numpy(), **_IMAGE_STYLE)
    if colorbar:
        ax.figure.colorbar(image, ax=ax, label="dB")
    return ax


def plot_spectrogram_grid(spectrograms, titles=None, ylabel="freq_bin"):
    """One row of panels (e.g. input / reconstruction / error). Returns the
    figure and the list of axes."""
    from matplotlib import pyplot as plt

    n = len(spectrograms)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for i, spec in enumerate(spectrograms):
        title = titles[i] if titles else None
        plot_spectrogram(spec, title=title, ylabel=ylabel if i == 0 else None, ax=axes[0][i])
    fig.tight_layout()
    return fig, list(axes[0])
