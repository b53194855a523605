"""The port's tool entry points on the CPU, and its coverage of the JAX
package's modules.

* ``cli.make_shifted_corpus`` writes byte-equal files to the JAX package's
  ``scripts/make_shifted_corpus.py`` run with the same arguments;
* ``cli.impulse_response_demo`` with ``--device cpu``, with and without
  ``--native``: its ``_rir.npy`` is bitwise the port's ``dsp.generate_rir``
  and, with ``--native``, the native library's output cast to float32, at
  the dataset's geometry; the dry wav is the seeded speech; the two RIRs
  agree within JAX's native-vs-XLA tolerance;
* the demo and ``cli.echoe_transfer`` catch a missing matplotlib only: an
  error raised while plotting propagates;
* every ``.py`` module of the JAX package has a counterpart at the same
  subpath of the port, except ``ops/vq_pallas.py``, whose kernels are the
  port's ``csrc/``.
"""

import importlib.util
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch import dsp, native
from acoustic_locating_vq_vae_torch.cli import echoe_transfer, impulse_response_demo, make_shifted_corpus
from acoustic_locating_vq_vae_torch.cli.run_pipeline import smoke_config
from acoustic_locating_vq_vae_torch.data import DatasetConfig, synthetic_speech_batch
from acoustic_locating_vq_vae_torch.eval import write_wav
from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask, checkpoint_metadata
from acoustic_locating_vq_vae_torch.utils import StageStore

REPO = Path(__file__).resolve().parents[1]
THETA = 0.7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_shifted_corpus_equals_the_jax_script(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_make_shifted_corpus", REPO / "scripts" / "make_shifted_corpus.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = ["--n", "3", "--samples", "4000", "--seed", "7"]
    monkeypatch.setattr(sys, "argv", ["make_shifted_corpus.py", "--out", str(tmp_path / "jax"), *args])
    script.main()
    make_shifted_corpus.main(["--out", str(tmp_path / "port"), *args])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["utt0000.wav", "utt0001.wav", "utt0002.wav"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.fixture(scope="module")
def geometry():
    cfg = DatasetConfig()
    recv = torch.tensor(cfg.receiver_position, dtype=torch.float32)
    src = dsp.source_coordinates(torch.tensor(THETA), recv, torch.tensor(cfg.room_dimensions), cfg.R, cfg.Z_LOC_SOURCE)
    return cfg, recv, src


@pytest.mark.parametrize("use_native", [False, True], ids=["torch", "native"])
def test_demo_writes_the_ports_rir(tmp_path, capsys, geometry, use_native):
    if use_native and shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native ISM library is built with g++ at first use")
    cfg, recv, src = geometry
    prefix = str(tmp_path / "demo")
    out = impulse_response_demo.main(["--device", "cpu", "--out-prefix", prefix, "--seed", "3"]
                                      + (["--native"] if use_native else []))
    printed = capsys.readouterr().out
    assert "theta=0.700 -> source" in printed
    for key in ("dry", "echoed", "rir"):
        assert Path(out[key]).is_file() and out[key].startswith(prefix)
    assert out["png"] is not None and Path(out["png"]).is_file()  # matplotlib is installed here
    got = np.load(out["rir"])
    assert got.dtype == np.float32 and got.shape == (cfg.n_sample,)
    if use_native:
        want = native.generate_rir_native(src, cfg.receiver_position, cfg.room_dimensions, cfg.n_sample, cfg.fs,
                                          rt60=cfg.reverberation_time).float().numpy()
        xla = dsp.generate_rir(src, recv, room=tuple(cfg.room_dimensions), nsample=cfg.n_sample, fs=float(cfg.fs),
                               rt60=cfg.reverberation_time).numpy()
        np.testing.assert_allclose(xla, want, atol=5e-4 * np.abs(want).max(), rtol=1e-2)
    else:
        want = dsp.generate_rir(src, recv, room=tuple(cfg.room_dimensions), nsample=cfg.n_sample, fs=float(cfg.fs),
                                rt60=cfg.reverberation_time).numpy()
    assert np.array_equal(got, want)
    dry = tmp_path / "want_dry.wav"
    write_wav(str(dry), synthetic_speech_batch(torch.Generator().manual_seed(3), 1, cfg.audio_samples, cfg.fs)[0],
              cfg.fs)
    assert Path(out["dry"]).read_bytes() == dry.read_bytes()


def _boom(*args, **kwargs):
    raise RuntimeError("plotting failed")


def test_demo_does_not_swallow_a_plot_error(tmp_path, monkeypatch):
    from matplotlib import pyplot

    monkeypatch.setattr(pyplot, "subplots", _boom)
    with pytest.raises(RuntimeError, match="plotting failed"):
        impulse_response_demo.main(["--device", "cpu", "--out-prefix", str(tmp_path / "demo")])
    assert (tmp_path / "demo_rir.npy").is_file()  # everything before the plot was written


def test_echoe_transfer_does_not_swallow_a_plot_error(tmp_path, monkeypatch):
    """The t-SNE is replaced by a fixed embedding (scikit-learn's cost is not
    the subject here); the plot's error reaches the caller."""
    from matplotlib import pyplot

    import acoustic_locating_vq_vae_torch.eval as port_eval

    task = EchoedSpeechTask(config=smoke_config(), width_scale=1 / 16)
    store = StageStore(str(tmp_path / "store"))
    store.save_stage("finetune", {"model": task.build_model(torch.Generator().manual_seed(0)).state_dict()},
                     metadata=checkpoint_metadata(task, True))
    monkeypatch.setattr(port_eval, "tsne_rir_embedding", lambda task, params, data, device: (np.zeros((4, 2)),
                                                                                            np.zeros(4)))
    monkeypatch.setattr(pyplot, "subplots", _boom)
    with pytest.raises(RuntimeError, match="plotting failed"):
        echoe_transfer.main(["--smoke", "--device", "cpu", "--width-scale", "0.0625", "--store-dir",
                             str(tmp_path / "store"), "--dataset-size", "4", "--val-size", "4", "--out",
                             str(tmp_path / "tsne.npz")])
    assert (tmp_path / "tsne.npz").is_file()


def test_every_jax_module_has_a_counterpart():
    """A module left out of the port shows here."""
    jax_pkg, port_pkg = REPO / "src" / "acoustic_locating_vq_vae_tpu", REPO / "src" / "acoustic_locating_vq_vae_torch"
    modules = sorted(p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py"))
    assert len(modules) > 40 and "native/ism.py" in modules and "utils/viz.py" in modules
    missing = [m for m in modules if not (port_pkg / m).is_file()]
    assert missing == ["ops/vq_pallas.py"]
    assert {p.name for p in (port_pkg / "csrc").glob("*.cu")} == {"vq_nearest.cu", "vq_codebook_accum.cu", "rir_taps.cu"}
    assert (port_pkg / "native" / "ism.cpp").is_file()
