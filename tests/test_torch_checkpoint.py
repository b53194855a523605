"""The port's checkpoints and stage store on the CPU: the counterpart of each
case of ``tests/test_checkpoint_gc.py`` (periodic-checkpoint GC, its ranking
by the manifest's ``seq`` counter, relocatable and contained deletes), a
bitwise round trip of a model with EMA buffers and of Adam's state through
the store (the restored optimizer takes the same next step), atomic writes,
the refusal of an orbax stage, and ``save_checkpoint``'s metadata against
the JAX ``Trainer.save_checkpoint``'s.

Widths are cut by ``width_scale = 1/32`` and the geometry to 33 bins x 64
frames; inputs are made with numpy."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch
from acoustic_locating_vq_vae_torch.train import JointLocationTask, SpeechVQVAETask, Trainer
from acoustic_locating_vq_vae_torch.utils import StageStore, load_state, save_state
from test_torch_kernels import assert_bitwise

GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
JSMALL, SMALL = JaxDatasetConfig(**GEOMETRY), DatasetConfig(**GEOMETRY)
F, T = SMALL.num_freq, SMALL.num_frames
WS = 1 / 32


def _arrays(b, seed):
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (b, F, T)).astype(np.float32)
    return dict(
        speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=np.full((b,), 16000, np.int32),
        theta=rng.uniform(-3, 3, b).astype(np.float32), wiener_est=rng.exponential(1.0, (b, F)).astype(np.float32),
        radius=rng.uniform(0.5, 1.5, b).astype(np.float32),
    )


@pytest.fixture(scope="module")
def batch():
    return SampleBatch(**{k: torch.from_numpy(v) for k, v in _arrays(16, 0).items()})


def _trainer(store, keep=0, seed=1, **task_kw):
    task = SpeechVQVAETask(config=SMALL, width_scale=WS, batch_size=8, ckpt_every=2, **task_kw)
    return Trainer(task, device="cpu", seed=seed, verbose=False, checkpoint_dir=str(store), keep_checkpoints=keep)


def _periodic_tags(store, name="speech"):
    return sorted(
        (t for t in store.stages() if t.startswith(f"{name}_") and t[len(name) + 1:].isdigit()),
        key=lambda t: int(t.split("_")[-1]),
    )


def _codebook(tr):
    return tr.model._vq._embedding.weight.detach().clone()


# ---------------------------------------------------------------- GC (tests/test_checkpoint_gc.py)


def test_gc_keeps_newest_n_and_final(tmp_path, batch):
    _trainer(tmp_path, keep=2).fit(batch, None, num_updates=10)
    store = StageStore(str(tmp_path))
    assert _periodic_tags(store) == ["speech_8", "speech_10"]
    assert store.has_stage("speech")  # the final is never GC'd
    stage_dirs = os.listdir(tmp_path / "stages")
    assert "speech_2" not in stage_dirs and "speech_4" not in stage_dirs


def test_gc_preserves_resume(tmp_path, batch):
    """GC keeps the newest periodic checkpoints, so restore_latest still
    resumes from the most recent step."""
    tr = _trainer(tmp_path, keep=1, seed=2)
    tr.fit(batch, None, num_updates=10)
    tr2 = _trainer(tmp_path, keep=1, seed=2)
    assert tr2.restore_latest() == 10 and tr2.step_count == 10
    assert torch.equal(_codebook(tr2), _codebook(tr))


def test_gc_and_resume_survive_stale_higher_step_tags(tmp_path, batch):
    """A retrain from scratch into a store still holding a previous run's
    higher-step periodic tags: GC ranks by the save counter (step-ranking
    would delete the current run's fresh saves in favour of the stale ones),
    and resume restores the current run's newest save."""
    _trainer(tmp_path, keep=0, seed=4).fit(batch, None, num_updates=10)
    store = StageStore(str(tmp_path))
    store.delete_stage("speech")  # drop the final so the retrain is "fresh"
    assert _periodic_tags(store) == ["speech_2", "speech_4", "speech_6", "speech_8", "speech_10"]

    tr2 = _trainer(tmp_path, keep=2, seed=4)
    tr2.fit(batch, None, num_updates=6)
    assert _periodic_tags(StageStore(str(tmp_path))) == ["speech_4", "speech_6"]

    tr3 = _trainer(tmp_path, keep=2, seed=4)
    assert tr3.restore_latest() == 6
    assert torch.equal(_codebook(tr3), _codebook(tr2))


def test_gc_and_resume_are_immune_to_wall_clock_steps(tmp_path, batch):
    """Recency is the manifest's monotonic seq counter, not wall time: a
    clock stepped back must not make GC delete the newest checkpoint or
    resume restore an older one."""
    _trainer(tmp_path, keep=2, seed=5).fit(batch, None, num_updates=6)
    store = StageStore(str(tmp_path))
    assert _periodic_tags(store) == ["speech_4", "speech_6"]
    m = json.load(open(store.manifest_path))
    assert m["speech_6"]["seq"] > m["speech_4"]["seq"]
    m["speech_6"]["time"] = m["speech_4"]["time"] - 300.0
    with open(store.manifest_path, "w") as f:
        json.dump(m, f)

    tr2 = _trainer(tmp_path, keep=2, seed=6)
    assert tr2.restore_latest() == 6  # seq outranks time
    tr2.fit(batch, None, num_updates=8, resume=True)  # one more save retires speech_4, not speech_6
    assert _periodic_tags(StageStore(str(tmp_path))) == ["speech_6", "speech_8"]


def test_default_keeps_everything(tmp_path, batch):
    _trainer(tmp_path, seed=3).fit(batch, None, num_updates=6)
    assert _periodic_tags(StageStore(str(tmp_path))) == ["speech_2", "speech_4", "speech_6"]


def test_copied_store_is_self_contained(tmp_path):
    """A copied store's manifest carries the original's absolute paths; stage
    resolution prefers the copy's own directories, so loading from the copy
    does not read the original and deleting from it never deletes the
    original's directories."""
    a = StageStore(str(tmp_path / "a"))
    a.save_stage("x", {"w": torch.full((4,), 7.0)}, step=3)
    shutil.copytree(tmp_path / "a", tmp_path / "b")

    b = StageStore(str(tmp_path / "b"))
    assert json.load(open(b.manifest_path))["x"]["path"].startswith(str(tmp_path / "a"))
    assert torch.equal(b.load_stage("x")["w"], torch.full((4,), 7.0))
    b.delete_stage("x")
    assert not b.has_stage("x")
    assert not os.path.isdir(tmp_path / "b" / "stages" / "x")
    assert os.path.isdir(tmp_path / "a" / "stages" / "x")
    a.load_stage("x")  # the original is intact


def test_delete_stage_never_reaches_outside_the_store(tmp_path):
    """A manifest entry pointing at a foreign directory with no local copy:
    delete_stage drops the entry and leaves the foreign directory alone."""
    a = StageStore(str(tmp_path / "a"))
    a.save_stage("x", {"w": torch.zeros(2)}, step=1)
    foreign = a.stages()["x"]["path"]

    b = StageStore(str(tmp_path / "b"))
    with open(b.manifest_path, "w") as f:
        json.dump({"x": {"path": foreign, "step": 1, "time": 0, "metadata": {}}}, f)
    b.delete_stage("x")
    assert not b.has_stage("x")
    assert os.path.isdir(foreign)


def test_delete_stage_is_idempotent(tmp_path):
    store = StageStore(str(tmp_path))
    store.save_stage("x", {"a": torch.ones(3)}, step=1)
    path = store.stages()["x"]["path"]
    assert os.path.isdir(path)
    store.delete_stage("x")
    assert not store.has_stage("x") and not os.path.isdir(path)
    store.delete_stage("x")  # absent: no-op, no raise


# ---------------------------------------------------------------- the store's format


def test_store_round_trip_is_bitwise_and_the_next_step_equal(tmp_path, batch):
    """A speech trainer with an EMA codebook, saved after 3 steps and
    restored into a fresh trainer: the state dict (EMA buffers included),
    Adam's state, the step and both generators are bitwise equal, and the
    next step of both gives bitwise equal weights and Adam state."""
    tr = _trainer(tmp_path, seed=7, vq_ema=True)
    tr.fit(batch, None, num_updates=3, save_final=False)
    tr.save_checkpoint("speech_3")
    assert {"_vq.ema_counts", "_vq.ema_sums"} <= set(tr.model.state_dict())
    other = _trainer(tmp_path, seed=8, vq_ema=True)
    assert other.restore_latest() == 3
    assert_bitwise(other.model.state_dict(), tr.model.state_dict(), "model")
    assert_bitwise(other.optimizer.state_dict(), tr.optimizer.state_dict(), "adam")
    assert torch.equal(other.sample_generator.get_state(), tr.sample_generator.get_state())
    assert torch.equal(other.jitter_generator.get_state(), tr.jitter_generator.get_state())
    assert_bitwise(other.load_stage_params("speech_3"), tr.model.state_dict(), "load_stage_params")
    tr.fit(batch, None, num_updates=4, save_final=False)
    other.fit(batch, None, num_updates=4, save_final=False)
    assert_bitwise(other.model.state_dict(), tr.model.state_dict(), "model after a step")
    assert_bitwise(other.optimizer.state_dict(), tr.optimizer.state_dict(), "adam after a step")


def test_stage_file_is_replaced_atomically(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous stage file whole and
    no temporary file behind."""
    store = StageStore(str(tmp_path))
    store.save_stage("x", {"w": torch.full((3,), 1.0)}, step=1)
    real_save = torch.save

    def dying_save(obj, f):
        with open(f, "wb") as out:
            out.write(b"torn")
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        store.save_stage("x", {"w": torch.full((3,), 2.0)}, step=2)
    monkeypatch.setattr(torch, "save", real_save)
    assert torch.equal(store.load_stage("x")["w"], torch.full((3,), 1.0))
    assert store.stages()["x"]["step"] == 1
    assert os.listdir(tmp_path / "stages" / "x") == ["state.pt"]
    save_state(str(tmp_path / "y.pt"), {"n": 3, "t": torch.arange(4)})
    assert_bitwise(load_state(str(tmp_path / "y.pt")), {"n": 3, "t": torch.arange(4)})


def test_an_orbax_stage_is_refused_by_name(tmp_path):
    """A stage directory without the port's file (an orbax stage of the JAX
    package) raises an error naming the weight importers, not a pickle
    error."""
    os.makedirs(tmp_path / "stages" / "speech")
    (tmp_path / "stages" / "speech" / "_METADATA").write_text("{}")
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"speech": {"path": str(tmp_path / "stages" / "speech"), "step": 5, "time": 0.0, "seq": 0,
                              "metadata": {"task": "speech", "final": True}}}, f)
    with pytest.raises(ValueError, match="params_from_jax.*composite_params_from_jax"):
        StageStore(str(tmp_path)).load_stage("speech")


def test_store_under_tmpdir_warns(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.warns(UserWarning, match="clears on reboot"):
        StageStore(str(tmp_path / "store"))


# ---------------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("name,kw", [("speech", {}), ("location_joint", dict(predict_radius=True))],
                         ids=["speech", "joint_radius"])
def test_checkpoint_metadata_matches_jax(tmp_path, name, kw):
    """The manifest metadata of one checkpoint equals the JAX Trainer's for
    the same task fields."""
    jtask = jtrain.make_task(name, config=JSMALL, width_scale=WS, **kw)
    jtr = jtrain.Trainer(jtask, checkpoint_dir=str(tmp_path / "jax"), verbose=False)
    state = jtr.init_state(jax.random.PRNGKey(0), JaxSampleBatch(**{k: jnp.asarray(v) for k, v in _arrays(2, 1).items()}))
    jtr.save_checkpoint(state, tag=f"{name}_1")
    want = json.load(open(tmp_path / "jax" / "manifest.json"))[f"{name}_1"]["metadata"]

    task = (JointLocationTask if name == "location_joint" else SpeechVQVAETask)(config=SMALL, width_scale=WS, **kw)
    tr = Trainer(task, device="cpu", verbose=False, checkpoint_dir=str(tmp_path / "port"))
    tr.save_checkpoint(f"{name}_1")
    got = json.load(open(tmp_path / "port" / "manifest.json"))[f"{name}_1"]["metadata"]
    assert got == want
