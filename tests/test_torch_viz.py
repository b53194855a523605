"""The port's ``utils.viz`` on matplotlib's Agg backend, against the JAX
package's ``utils/viz.py``: the line mode's data bitwise, the image mode's
dB data within 1e-5 of its largest magnitude, with the low frequencies at the
bottom, the colorbar, the grid's one row of panels; and matplotlib imported
by the functions only."""

import os
import subprocess
import sys
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
from matplotlib import pyplot as plt  # noqa: E402

from acoustic_locating_vq_vae_tpu.utils import viz as jviz  # noqa: E402
from acoustic_locating_vq_vae_torch import utils  # noqa: E402
from acoustic_locating_vq_vae_torch.utils import plot_spectrogram, plot_spectrogram_grid  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)
SPEC = (np.abs(RNG.standard_normal((20, 30))) ** 2).astype(np.float32)
SPEC[0, 0] = 1e-12  # below the 80 dB floor
SIGNAL = RNG.standard_normal(50).astype(np.float32)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


@pytest.mark.parametrize("signal", [SIGNAL, SIGNAL[None], torch.from_numpy(SIGNAL), torch.from_numpy(SIGNAL)[None]],
                         ids=["1d", "one-row", "tensor", "tensor-one-row"])
def test_line_mode_matches_jax_bitwise(signal):
    ax = plot_spectrogram(signal, title="x")
    want = jviz.plot_spectrogram(np.asarray(signal))
    assert len(ax.lines) == 1 and not ax.images
    assert np.array_equal(ax.lines[0].get_ydata(), want.lines[0].get_ydata())
    assert ax.get_title() == "x" and ax.get_ylabel() == "freq_bin"


@pytest.mark.parametrize("spec", [SPEC, torch.from_numpy(SPEC)], ids=["array", "tensor"])
def test_image_mode_matches_jax(spec):
    ax = plot_spectrogram(spec, ylabel="bin")
    want = jviz.plot_spectrogram(SPEC)
    got_img, want_img = ax.images[0], want.images[0]
    assert not ax.lines and got_img.origin == want_img.origin == "lower"
    assert got_img.get_array().shape == SPEC.shape
    got, ref = np.asarray(got_img.get_array()), np.asarray(want_img.get_array())
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert got.min() == pytest.approx(got.max() - 80.0, abs=1e-4)  # the top_db floor
    assert ax.get_ylabel() == "bin" and not ax.get_title()


def test_given_axis_and_colorbar():
    fig, target = plt.subplots()
    ax = plot_spectrogram(torch.from_numpy(SPEC), ax=target, colorbar=True)
    assert ax is target
    assert len(fig.axes) == 2 and fig.axes[1].get_ylabel() == "dB"
    assert len(plot_spectrogram(SPEC).figure.axes) == 1  # no colorbar by default


def test_grid_is_one_row_of_panels():
    specs = [SPEC, torch.from_numpy(SPEC), SIGNAL]
    fig, axes = plot_spectrogram_grid(specs, titles=["in", "recon", "signal"])
    jfig, jaxes = jviz.plot_spectrogram_grid([SPEC, SPEC, SIGNAL], titles=["in", "recon", "signal"])
    assert len(axes) == len(jaxes) == 3 and len(fig.axes) == len(jfig.axes) == 3
    assert [a.get_title() for a in axes] == ["in", "recon", "signal"]
    assert [a.get_ylabel() for a in axes] == [a.get_ylabel() for a in jaxes] == ["freq_bin", "", ""]
    assert tuple(fig.get_size_inches()) == tuple(jfig.get_size_inches()) == (12.0, 3.0)
    assert len(axes[0].images) == len(axes[1].images) == 1 and len(axes[2].lines) == 1


def test_exported_and_matplotlib_imported_lazily():
    assert utils.plot_spectrogram is plot_spectrogram and utils.plot_spectrogram_grid is plot_spectrogram_grid
    code = ("import sys; import acoustic_locating_vq_vae_torch.utils, acoustic_locating_vq_vae_torch.utils.viz; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.stdout.strip() == "False"
