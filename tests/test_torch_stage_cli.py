"""The port's per-stage training CLIs and the data surface they read, on the
CPU, against the JAX package where it has the same function.

* The chain ``train_speech --host-staged 4 --rotate-every 1`` ->
  ``train_rir --vq-ema --prune-dataset`` -> ``train_echoed_speech`` ->
  ``encoder_training_echoed_model`` -> ``train_location --joint`` trains run
  K's stages one command at a time on one store (module-scoped, in process,
  smoke geometry at width 1/32, 2 updates a stage); each stage's stored
  weights are bitwise ``run_stage(task, seed + k, ...)`` on the sets
  ``load_datasets`` gives for the same flags, with the JAX scripts' handoffs.
  A preempted stage exits 75 and ``--resume`` finishes it bitwise; a
  resumed stage at its count prints JAX's "already at/past" line.
* ``--librispeech-dir`` feeds the speech of a stage CLI; it excludes
  ``--wav-dir``; ``--prune-dataset`` is ignored outside a stage, with JAX's
  message; the pipeline trains its six stages from one host-staged set.
* Bitwise JAX's on the same inputs: ``decode_flac`` on the byte streams of
  ``tests/test_flac.py``'s encoder (verbatim, constant, fixed orders with
  partitions and an escape, LPC, the four stereo modes, wasted bits, a CRC
  failure), ``load_librispeech`` on both layouts of ``.wav`` and of
  ``.flac`` with soundfile hidden, the reference collate, ``SpecsDataset``'s
  attributes, ``get_source_coordinates`` and ``load_all`` on ``.npz`` and
  ``.pt`` directories, ``test_data_set``'s report and ``summarize_sweep``'s
  tables.
"""

import builtins
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch import data as D
from acoustic_locating_vq_vae_torch.cli import (
    common, encoder_training_echoed_model, summarize_sweep, test_data_set, train_echoed_speech, train_location,
    train_rir, train_speech,
)
from acoustic_locating_vq_vae_torch.cli.run_pipeline import exit_on_preemption, load_datasets
from acoustic_locating_vq_vae_torch.train import (
    EchoedSpeechTask, EncoderFinetuneTask, JointLocationTask, LocationTask, RirVQVAETask, SpeechVQVAETask, Trainer,
    graft_pretrained, run_stage,
)
from acoustic_locating_vq_vae_torch.utils import StageStore

REPO = Path(__file__).resolve().parents[1]
WS = 1 / 32
FLAGS = ["--smoke", "--device", "cpu", "--width-scale", str(WS), "--updates", "2", "--dataset-size", "8",
         "--val-size", "4", "--vq-flatten", "vectors", "--log-every", "100"]
CHAIN = (  # (module, stage, seed offset, extra flags)
    (train_speech, "speech", 1, ["--host-staged", "4", "--rotate-every", "1"]),
    (train_rir, "rir", 2, ["--vq-ema", "--prune-dataset"]),
    (train_echoed_speech, "echoed", 3, []),
    (encoder_training_echoed_model, "finetune", 4, []),
    (train_location, "location_joint", 5, ["--joint"]),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU ops run faster on one thread, alone and beside the
    suite's other workers; the setting comes back after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _load_script(name: str):
    """A JAX-package script as a module of its own (``scripts/`` on the path for its ``_common``)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return module


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Run the five stage CLIs on one store; returns (store dir, each stage's printed output)."""
    store = str(tmp_path_factory.mktemp("stages") / "store")
    printed = {}
    for module, stage, _, extra in CHAIN:
        out = tmp_path_factory.mktemp(stage) / "out.txt"
        with open(out, "w") as f:
            stdout, sys.stdout = sys.stdout, f
            try:
                module.main([*FLAGS, "--store-dir", store, *extra])
            finally:
                sys.stdout = stdout
        printed[stage] = out.read_text()
    return store, printed


def _parse(module, extra):
    parser = module.build_parser() if hasattr(module, "build_parser") else common.stage_parser("")
    return parser.parse_args([*FLAGS, *extra])


def _reference(stage: str, store: StageStore):
    """The stage trained by run_stage on load_datasets' sets for the CLI's flags, from the CLI's donors."""
    module, _, k, extra = next(c for c in CHAIN if c[1] == stage)
    args = _parse(module, extra)
    tasks = {"speech": SpeechVQVAETask, "rir": RirVQVAETask, "echoed": EchoedSpeechTask,
             "finetune": EncoderFinetuneTask, "location_joint": JointLocationTask}
    fields = (LocationTask if stage == "location_joint" else tasks[stage])().resident_fields
    _, train, val = load_datasets(args, fields)
    kw = dict(config=D.DatasetConfig(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32),
              width_scale=WS, compat_vq_flatten=False)
    initial = None
    if stage in ("speech", "rir"):
        task = tasks[stage](**kw, vq_ema=stage == "rir")
    elif stage == "echoed":
        task = EchoedSpeechTask(**kw)
        initial = lambda fresh: graft_pretrained(fresh, store.load_stage("speech")["model"],
                                                 store.load_stage("rir")["model"])
    elif stage == "finetune":
        task, initial = EncoderFinetuneTask(**kw, commitment_weight=0.0), store.load_stage("echoed")["model"]
    else:
        task = JointLocationTask(**kw, commitment_weight=0.25)
        initial = lambda fresh: task.seed_params(fresh, store.load_stage("finetune")["model"])
    trainer, _ = run_stage(task, args.seed + k, train, val, None, 2, initial_params=initial, device="cpu",
                           verbose=False)
    return trainer.state_dict()


@pytest.mark.parametrize("stage", [c[1] for c in CHAIN])
def test_stage_cli_is_run_stage(chain, stage):
    """The store holds each stage, final, bitwise run_stage's weights; JAX's closing lines."""
    root, printed = chain
    store = StageStore(root)
    assert store.has_stage(stage) and store.stage_metadata(stage)["final"]
    got = store.load_stage(stage)["model"]
    want = _reference(stage, store)
    assert got.keys() == want.keys()
    for name, v in want.items():
        assert torch.equal(got[name], v), (stage, name)
    if stage == "location_joint":
        assert "using composite from stage 'finetune'" in printed[stage]
        assert "done: final location MSE" in printed[stage] and "target (sin,cos)" in printed[stage]
        assert "joint location evaluation:" in printed[stage]
    else:
        assert "done: final recon_error" in printed[stage] and f"stage {stage!r} saved to {root}" in printed[stage]
    if stage == "speech":
        assert "[speech] host-staged dataset: 8 rows, 2 chunks of 4 resident, rotating every 1 steps" in printed[stage]
    if stage == "rir":
        assert "--prune-dataset" not in printed[stage]


def test_preempted_stage_exits_75_and_resumes_bitwise(chain, tmp_path, monkeypatch, capsys):
    """SIGTERM's flag after the first step: a checkpoint and exit 75; --resume
    finishes bitwise the chain's stage; a second --resume, from the periodic
    checkpoint at the stage's count, has nothing to do."""
    root, _ = chain
    store = str(tmp_path / "store")
    argv = [*FLAGS, "--store-dir", store, "--vq-ema", "--prune-dataset", "--ckpt-every", "1"]
    step = Trainer.step

    def stop_after_one(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        self.request_preemption()
        return out

    monkeypatch.setattr(Trainer, "step", stop_after_one)
    with pytest.raises(SystemExit) as stopped, exit_on_preemption():
        train_rir.main(argv)
    assert stopped.value.code == 75
    monkeypatch.setattr(Trainer, "step", step)
    train_rir.main([*argv, "--resume"])
    got, want = StageStore(store).load_stage("rir")["model"], StageStore(root).load_stage("rir")["model"]
    assert all(torch.equal(got[k], v) for k, v in want.items())
    capsys.readouterr()
    train_rir.main([*argv, "--resume"])
    assert "stage 'rir' already at/past 2 updates; nothing to train (--resume)" in capsys.readouterr().out


def test_missing_donors_warn(tmp_path, capsys):
    train_echoed_speech.main([*FLAGS, "--store-dir", str(tmp_path / "empty"), "--updates", "1"])
    assert "WARNING: missing pretrained speech/rir stage in store; using fresh init" in capsys.readouterr().out


# ---------------------------------------------------------------- the corpus


def _write_wav(path: Path, samples: np.ndarray, rate: int = 16000) -> None:
    from scipy.io import wavfile

    path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(path, rate, samples)


def _wav_layout(root: Path, url: str, nested: bool = True) -> None:
    rng = np.random.default_rng(9)
    base = root / "LibriSpeech" / url if nested else root / url
    for spk, chp, n in (("84", "121123", 2), ("174", "50561", 1)):
        for u in range(n):
            name = base / spk / chp / f"{spk}-{chp}-{u:04d}.wav"
            if u == 1:  # a float stereo utterance longer than the pool rows
                _write_wav(name, rng.uniform(-0.5, 0.5, (4000, 2)).astype(np.float32))
            else:
                _write_wav(name, rng.integers(-20000, 20000, 2500).astype(np.int16))


@pytest.mark.parametrize("nested", [True, False])
def test_load_librispeech_wav_matches_jax(tmp_path, nested):
    from acoustic_locating_vq_vae_tpu.data.speech import load_librispeech as jax_load

    _wav_layout(tmp_path, "dev-clean", nested)
    for limit in (None, 2):
        got = D.load_librispeech(str(tmp_path), url="dev-clean", num_samples=3200, limit=limit)
        want = jax_load(str(tmp_path), url="dev-clean", num_samples=3200, limit=limit)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError, match="no LibriSpeech split"):
        D.load_librispeech(str(tmp_path), url="test-other")


def _hide_soundfile(monkeypatch):
    monkeypatch.delitem(sys.modules, "soundfile", raising=False)
    real_import = builtins.__import__

    def no_soundfile(name, *a, **k):
        if name == "soundfile":
            raise ImportError("soundfile hidden")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_soundfile)


def test_load_librispeech_flac_matches_jax(tmp_path, monkeypatch):
    """FLAC utterances through the built-in decoder, soundfile hidden."""
    from test_flac import BitWriter, make_flac, sub_fixed

    from acoustic_locating_vq_vae_tpu.data.speech import load_librispeech as jax_load

    d = tmp_path / "LibriSpeech" / "dev-clean" / "84" / "121123"
    d.mkdir(parents=True)
    t = np.arange(1500)
    for i in range(2):
        w = BitWriter()
        sub_fixed(w, (3000 * np.sin(t * (0.02 + 0.01 * i))).astype(int).tolist(), 2, 16, param=7)
        (d / f"84-121123-{i:04d}.flac").write_bytes(make_flac(16000, 1, 16, [(1500, 0, w)]))
    _hide_soundfile(monkeypatch)
    got = D.load_librispeech(str(tmp_path), url="dev-clean", num_samples=2000)
    want = jax_load(str(tmp_path), url="dev-clean", num_samples=2000)
    assert got.shape == (2, 2000)
    np.testing.assert_array_equal(got, want)


def _flac_streams():
    """(label, bytes) of every stream kind tests/test_flac.py encodes."""
    from test_flac import BitWriter, make_flac, rice_residual, sub_constant, sub_fixed, sub_verbatim

    rng = np.random.default_rng(0)
    out = []
    w, w2 = BitWriter(), BitWriter()
    sub_verbatim(w, rng.integers(-(1 << 15), 1 << 15, 96).tolist(), 16)
    sub_constant(w2, -1234, 16)
    out.append(("verbatim+constant", make_flac(16000, 1, 16, [(96, 0, w), (96, 0, w2)])))
    t = np.arange(128)
    smooth = (2000 * np.sin(t * 0.1) + 500 * np.cos(t * 0.37)).astype(int).tolist()
    for order in range(5):
        w = BitWriter()
        sub_fixed(w, smooth, order, 16, param=6)
        out.append((f"fixed{order}", make_flac(16000, 1, 16, [(128, 0, w)])))
    w = BitWriter()
    sub_fixed(w, smooth, 2, 16, param=6, part_order=2, escape_raw={1: 14})
    out.append(("partitions+escape", make_flac(44100, 1, 16, [(128, 0, w)])))
    order, prec, shift, coef, warm = 3, 12, 5, [20, -10, 5], [100, -250, 375]
    w = BitWriter()
    w.u(0, 1).u(32 + order - 1, 6).u(0, 1)
    for s in warm:
        w.s(s, 16)
    w.u(prec - 1, 4).s(shift, 5)
    for c in coef:
        w.s(c, prec)
    rice_residual(w, rng.integers(-40, 40, 64 - order).tolist(), 4, block_size=64, pred_order=order)
    out.append(("lpc", make_flac(16000, 1, 16, [(64, 0, w)])))
    left, right = rng.integers(-(1 << 14), 1 << 14, (2, 48)).tolist()
    side = [a - b for a, b in zip(left, right)]
    mid = [(a + b) >> 1 for a, b in zip(left, right)]
    for code, (c0, b0), (c1, b1) in ((1, (left, 16), (right, 16)), (8, (left, 16), (side, 17)),
                                     (9, (side, 17), (right, 16)), (10, (mid, 16), (side, 17))):
        w = BitWriter()
        sub_verbatim(w, c0, b0)
        sub_verbatim(w, c1, b1)
        out.append((f"stereo{code}", make_flac(16000, 2, 16, [(48, code, w)])))
    w = BitWriter()
    sub_verbatim(w, [s << 3 for s in (-100, 250, 77, -3, 0, 12, 99, -128)], 16, wasted=3)
    out.append(("wasted", make_flac(16000, 1, 16, [(8, 0, w)])))
    return out


def test_decode_flac_matches_jax():
    """Every stream decodes bitwise as JAX's decoder does (samples and rate);
    a bad magic and a flipped frame bit raise JAX's errors."""
    from test_flac import BitWriter, make_flac, sub_constant

    from acoustic_locating_vq_vae_tpu.data.flac import decode_flac as jax_decode

    for label, stream in _flac_streams():
        got, want = D.decode_flac(stream), jax_decode(stream)
        assert got[1] == want[1], label
        np.testing.assert_array_equal(got[0], want[0], err_msg=label)
    w = BitWriter()
    sub_constant(w, 5, 16)
    data = bytearray(make_flac(16000, 1, 16, [(16, 0, w)]))
    with pytest.raises(ValueError, match="fLaC magic"):
        D.decode_flac(b"RIFF" + bytes(data[4:]))
    data[-3] ^= 0x10
    for decode in (D.decode_flac, jax_decode):
        with pytest.raises(ValueError, match="CRC"):
            decode(bytes(data))


# ---------------------------------------------------------------- the data surface


def test_collate_matches_jax():
    from acoustic_locating_vq_vae_tpu.data import collate as jax_collate

    rng = np.random.default_rng(4)
    items = [(rng.random((5, t), np.float32), rng.random((5, t), np.float32), rng.random((5, t), np.float32),
              16000, np.array([0.1 * i]), rng.random(5, np.float32)) for i, t in enumerate((8, 6, 9))]
    for num_frames in (7, 8, 20):
        got = D.spec_dataset_preprocessing(items, num_frames=num_frames)
        want = jax_collate.spec_dataset_preprocessing(items, num_frames=num_frames)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    arrays = [rng.random((1, 4, n)) for n in (7, 5, 9)]
    np.testing.assert_array_equal(D.combine_arrays_with_min_dim(arrays),
                                  jax_collate.combine_arrays_with_min_dim(arrays))
    for bad in ([], [rng.random((1, 4, 3)), rng.random((1, 5, 3))]):
        with pytest.raises(ValueError):
            D.combine_arrays_with_min_dim(bad)


def _dataset_dirs(tmp_path):
    cfg = D.DatasetConfig(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)
    batch = D.make_dataset(torch.Generator().manual_seed(3), 3, cfg, batch=3, device="cpu", rir_chunk=2048,
                           radius_range=(0.5, 1.2))
    D.save_dataset(str(tmp_path / "npz"), batch, cfg)
    D.save_dataset_reference_format(str(tmp_path / "pt"), batch, cfg)
    return cfg, [tmp_path / "npz", tmp_path / "pt"]


ATTRS = ("fs", "receiver_position", "room_dimensions", "reverberation_time", "n_sample", "R", "NFFT", "HOP_LENGTH",
         "Z_LOC_SOURCE")


def test_specs_dataset_surface_matches_jax(tmp_path, capsys, monkeypatch):
    """The reference attributes, get_source_coordinates, load_all (the
    radius from .npz files) and test_data_set's report equal JAX's on a
    directory of each format."""
    from acoustic_locating_vq_vae_tpu.data import SpecsDataset as JaxSpecs

    jax_report = _load_script("test_data_set")
    _, dirs = _dataset_dirs(tmp_path)
    theta = np.array([[-3.0, 0.2], [1.5, 3.1]])
    for d in dirs:
        mine, theirs = D.SpecsDataset(str(d)), JaxSpecs(str(d))
        for a in ATTRS:
            np.testing.assert_array_equal(getattr(mine, a), getattr(theirs, a), err_msg=a)
        np.testing.assert_array_equal(mine.get_source_coordinates(theta), theirs.get_source_coordinates(theta))
        got, want = mine.load_all(), theirs.load_all()
        for k in D.SampleBatch._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=f"{d} {k}")
        for t in (50, 101):
            if t > 100:
                with pytest.raises(ValueError, match="fewer than 101 time frames"):
                    mine.load_all(num_frames=t)
            else:
                assert mine.load_all(num_frames=t).speech_spec.shape == (3, 33, t)
        capsys.readouterr()
        test_data_set.main([str(d)])
        got_report = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["test_data_set.py", str(d)])
        jax_report.main()
        assert got_report == capsys.readouterr().out
        assert got_report.endswith("ok\n") and "3 samples; fs=16000 NFFT=64 hop=32" in got_report


def test_summarize_sweep_matches_jax(tmp_path, capsys, monkeypatch):
    from test_summarize_sweep import SAMPLE

    theirs = _load_script("summarize_sweep")
    log = tmp_path / "sweep.log"
    log.write_text(SAMPLE)
    cells = list(summarize_sweep.parse_cells(SAMPLE.splitlines()))
    assert cells == list(theirs.parse_cells(SAMPLE.splitlines()))
    for metrics in (summarize_sweep.DEFAULT_METRICS, ["rmse_coordinates_m", "not_a_metric"]):
        assert summarize_sweep.render(cells, metrics) == theirs.render(cells, metrics)
    for argv in ([str(log)], ["--metrics", "median_abs_radians", "--", str(log)]):
        summarize_sweep.main(argv)
        got = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["summarize_sweep.py", *argv])
        theirs.main()
        assert got == capsys.readouterr().out
    empty = tmp_path / "empty.log"
    empty.write_text("no grid lines here\n")
    with pytest.raises(SystemExit, match="no grid-cell lines"):
        summarize_sweep.main([str(empty)])


# ---------------------------------------------------------------- the flags


def test_librispeech_dir_feeds_a_stage(tmp_path, capsys):
    _wav_layout(tmp_path / "corpus", "train-clean-100")
    store = tmp_path / "store"
    train_speech.main([*FLAGS, "--store-dir", str(store), "--updates", "1", "--librispeech-dir",
                       str(tmp_path / "corpus")])
    out = capsys.readouterr().out
    assert f"speech corpus: 3 LibriSpeech train-clean-100 utterances from {tmp_path / 'corpus'}" in out
    assert StageStore(str(store)).has_stage("speech")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_speech.main([*FLAGS, "--store-dir", str(store), "--wav-dir", str(tmp_path),
                           "--librispeech-dir", str(tmp_path / "corpus")])


def test_prune_dataset_is_stage_scoped(capsys):
    args = _parse(train_rir, ["--prune-dataset", "--val-size", "2", "--dataset-size", "2"])
    _, train, _ = load_datasets(args)
    assert "--prune-dataset ignored: this entry point is not stage-scoped" in capsys.readouterr().out
    assert train.speech_spec.shape[1:] == (33, 100)
    _, train, val = load_datasets(args, RirVQVAETask().resident_fields)
    for data in (train, val):
        assert data.speech_spec.shape[1:] == (0, 0) and data.rir_spec.shape[1:] == (33, 100)


def test_pipeline_trains_every_stage_from_one_host_set(tmp_path, capsys):
    """run_pipeline --host-staged: the six stages share one pinned-host set
    (--prune-dataset ignored, with JAX's message), and without a validation
    set the evaluations read the host set's rows."""
    from acoustic_locating_vq_vae_torch.cli import run_pipeline

    run_pipeline.main(["--smoke", "--device", "cpu", "--width-scale", str(WS), "--updates", "1", "--dataset-size",
                       "8", "--val-size", "0", "--store-dir", str(tmp_path), "--host-staged", "4", "--rotate-every",
                       "1", "--prune-dataset", "--joint-location", "--log-every", "100"])
    out = capsys.readouterr().out
    assert "--prune-dataset ignored: this entry point is not stage-scoped" in out
    assert out.count("host-staged dataset: 8 rows, 2 chunks of 4 resident, rotating every 1 steps") == 6
    assert '"num_samples": 8' in out and "joint location evaluation:" in out
