"""The port's preemption, resume and six-stage pipeline on the CPU: the
counterpart of ``tests/test_preemption.py`` (a preempted ``fit`` checkpoints
and resumes bitwise equal to an uninterrupted run, drawing the same batches
and jitter decisions; nothing is saved before the first step; a real
SIGTERM to the pipeline CLI gives exit 75 and ``--resume`` completes) and of
``tests/test_pipeline_resume.py`` (kill and restart skips the completed
stages, ``resume`` needs a store, a store of the other VQ flatten is
refused); the stage handoffs; and, against the JAX package, the tasks that
``run_pipeline`` builds for both presets and ``evaluate_location`` /
``evaluate_joint_location`` on the same weights and batch.

Widths are cut by ``width_scale = 1/32`` and the geometry to 33 bins x 64
frames; inputs are made with numpy. Convolution sums run in another order
in XLA-CPU and torch-CPU, so evaluation metrics agree within rtol 1e-4."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_tpu import eval as jeval
from acoustic_locating_vq_vae_tpu import train as jtrain
from acoustic_locating_vq_vae_tpu.data import DatasetConfig as JaxDatasetConfig
from acoustic_locating_vq_vae_tpu.data import SpecsDataset as JaxSpecsDataset
from acoustic_locating_vq_vae_tpu.data.synth import SampleBatch as JaxSampleBatch
from acoustic_locating_vq_vae_tpu.train import pipeline as jpipeline
from acoustic_locating_vq_vae_torch.data import DatasetConfig, SampleBatch, SpecsDataset, save_dataset
from acoustic_locating_vq_vae_torch.dsp import znorm
from acoustic_locating_vq_vae_torch.eval import (
    compare_location_models,
    composite_params_from_jax,
    evaluate_joint_location,
    evaluate_location,
    infer_location_modes,
    infer_target_mode,
    params_from_jax,
)
from acoustic_locating_vq_vae_torch.train import (
    JointLocationTask,
    LocationTask,
    Preempted,
    SpeechVQVAETask,
    Trainer,
    graft_pretrained,
    pipeline,
    run_pipeline,
    run_stage,
    stage_seed,
)
from acoustic_locating_vq_vae_torch.utils import StageStore
from test_torch_kernels import assert_bitwise

GEOMETRY = dict(n_sample=512, audio_samples=3200, num_frames=64, NFFT=64, HOP_LENGTH=32)
JSMALL, SMALL = JaxDatasetConfig(**GEOMETRY), DatasetConfig(**GEOMETRY)
F, T = SMALL.num_freq, SMALL.num_frames
WS = 1 / 32
RTOL = 1e-4
UPDATES = {"speech": 2, "rir": 2, "echoed": 4, "finetune": 2, "location": 2, "location_joint": 2}
STAGES = tuple(UPDATES)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(b, seed):
    """A numpy sample batch: non-negative spectrograms (B, F, T), angles
    away from the +-pi seam, radii."""
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (b, F, T)).astype(np.float32)
    return dict(
        speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=np.full((b,), 16000, np.int32),
        theta=rng.uniform(-3, 3, b).astype(np.float32), wiener_est=rng.exponential(1.0, (b, F)).astype(np.float32),
        radius=rng.uniform(0.5, 1.5, b).astype(np.float32),
    )


def _torch_batch(d):
    return SampleBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


def _jax_batch(d):
    return JaxSampleBatch(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def datasets():
    return _torch_batch(_arrays(16, 0)), _torch_batch(_arrays(8, 1))


def _speech_trainer(store=None, seed=2):
    task = SpeechVQVAETask(config=SMALL, width_scale=WS, batch_size=8, eval_every=4)
    return Trainer(task, device="cpu", seed=seed, verbose=False, checkpoint_dir=str(store) if store else None)


def _preempt_at(trainer, call):
    """Make the trainer ask for preemption during its ``call``-th step, as
    the SIGTERM handler would."""
    step, n = trainer.step, [0]

    def stepping(*a, **kw):
        n[0] += 1
        if n[0] == call:
            trainer.request_preemption()
        return step(*a, **kw)

    trainer.step = stepping


def _final_states(store_dir, stages=STAGES):
    store = StageStore(str(store_dir))
    return {s: store.load_stage(s) for s in stages}


# ---------------------------------------------------------------- preemption (tests/test_preemption.py)


def test_preempt_mid_fit_checkpoints_and_resumes(datasets, tmp_path, capsys):
    """Preemption during update 3 of 10 saves tag speech_3 and no final; a
    fresh trainer with resume=True continues from step 3, runs the other 7
    and ends bitwise equal to an uninterrupted run, Adam and generators too."""
    train, val = datasets
    straight = _speech_trainer()
    straight.fit(train, val, num_updates=10)

    tr = _speech_trainer(tmp_path)
    _preempt_at(tr, 3)
    with pytest.raises(Preempted) as ei:
        tr.fit(train, val, num_updates=10)
    assert ei.value.completed == 3
    assert not tr._preempt_requested  # the flag is cleared on the way out
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["speech_3"]["step"] == 3
    assert "speech" not in manifest  # no final checkpoint: the stage is incomplete

    tr2 = _speech_trainer(tmp_path)
    tr2.verbose = True
    history = tr2.fit(train, val, num_updates=10, resume=True)
    assert "[speech] resumed at step 3" in capsys.readouterr().out
    assert tr2.step_count == 10
    assert len(history.train["loss"]) + len(history.val["loss"]) == 7
    assert json.load(open(tmp_path / "manifest.json"))["speech"]["metadata"]["final"] is True
    assert_bitwise(tr2.model.state_dict(), straight.model.state_dict(), "model")
    assert_bitwise(tr2.optimizer.state_dict(), straight.optimizer.state_dict(), "adam")
    assert torch.equal(tr2.sample_generator.get_state(), straight.sample_generator.get_state())
    assert torch.equal(tr2.jitter_generator.get_state(), straight.jitter_generator.get_state())


def test_preempt_before_first_step_saves_nothing(datasets, tmp_path):
    train, val = datasets
    tr = _speech_trainer(tmp_path)
    tr.request_preemption()
    with pytest.raises(Preempted) as ei:
        tr.fit(train, val, num_updates=10)
    assert ei.value.completed == 0
    assert not os.path.exists(tmp_path / "manifest.json")


def test_resume_draws_the_same_batches_and_jitter_decisions(datasets, tmp_path):
    """The batch indices and the jitter generator's state before every step
    after a resume are those of the same steps of an uninterrupted run."""
    train, val = datasets

    def recording(trainer):
        seen = []
        indices = trainer._indices

        def record(data):
            idx = indices(data)
            seen.append((idx.clone(), trainer.jitter_generator.get_state()))
            return idx

        trainer._indices = record
        return seen

    straight = _speech_trainer(seed=9)
    ref = recording(straight)
    straight.fit(train, val, num_updates=10)

    tr = _speech_trainer(tmp_path, seed=9)
    _preempt_at(tr, 5)
    with pytest.raises(Preempted):
        tr.fit(train, val, num_updates=10)
    tr2 = _speech_trainer(tmp_path, seed=9)
    got = recording(tr2)
    tr2.fit(train, val, num_updates=10, resume=True)
    assert len(got) == 5 and len(ref) == 10
    for (idx, jit), (idx_ref, jit_ref) in zip(got, ref[5:]):
        assert torch.equal(idx, idx_ref) and torch.equal(jit, jit_ref)


def _read_until(proc, needle, deadline_s):
    lines = []
    end = time.time() + deadline_s
    while time.time() < end:
        line = proc.stdout.readline()
        if line == "" and proc.poll() is not None:
            break
        lines.append(line)
        if needle in line:
            return lines
    raise AssertionError(f"child never printed {needle!r} within {deadline_s}s:\n{''.join(lines)}")


def test_real_sigterm_to_the_cli_then_resume(tmp_path):
    """A real SIGTERM to the pipeline CLI in the middle of its first stage:
    exit 75 with a checkpoint in the store; rerun with --resume: the stage
    continues from the saved step and the pipeline completes."""
    data = tmp_path / "data"
    save_dataset(str(data), _torch_batch(_arrays(16, 3)), SMALL)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    base = [sys.executable, "-u", "-m", "acoustic_locating_vq_vae_torch.cli.run_pipeline", "--data-dir", str(data),
            "--store-dir", str(tmp_path / "store"), "--device", "cpu", "--width-scale", str(WS), "--log-every", "5",
            "--seed", "3", "--val-size", "0"]
    proc = subprocess.Popen(base + ["--updates", "100000"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    try:
        _read_until(proc, "[speech] 5 iterations", deadline_s=120)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 75, out
    assert "[preempted]" in out and "--resume" in out
    manifest = json.load(open(tmp_path / "store" / "manifest.json"))
    saved = max(m["step"] for t, m in manifest.items() if t.startswith("speech_"))
    assert saved >= 5 and "speech" not in manifest

    res = subprocess.run(base + ["--updates", str(saved + 2), "--resume"], capture_output=True, text=True,
                         env=env, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"[speech] resumed at step {saved}" in res.stdout
    assert "final location evaluation" in res.stdout
    final = json.load(open(tmp_path / "store" / "manifest.json"))
    for stage in ("speech", "rir", "echoed", "finetune", "location"):
        assert final[stage]["metadata"]["final"] is True and final[stage]["step"] == saved + 2, stage


# ---------------------------------------------------------------- the pipeline (tests/test_pipeline_resume.py)


def _pipeline(store, train, val, **kw):
    return run_pipeline(7, train, val, store_dir=str(store), config=SMALL, width_scale=WS, updates=UPDATES,
                        ckpt_every=2, joint_location=True, predict_radius=True, device="cpu", verbose=False,
                        cache_frozen=True, **kw)


def test_pipeline_kill_and_restart(datasets, tmp_path, capsys, monkeypatch):
    """Kill the pipeline right after the echoed stage's first periodic
    checkpoint; the resumed run reuses speech and RIR from the store,
    continues the echoed stage from step 2 and ends with every stage's final
    state dict and Adam state bitwise equal to an uninterrupted run's."""
    train, val = datasets
    _pipeline(tmp_path / "straight", train, val)

    save = Trainer.save_checkpoint

    def crashing_save(self, tag, final=False):
        save(self, tag, final=final)
        if tag == "echoed_2":
            raise KeyboardInterrupt("simulated crash in the echoed stage")

    monkeypatch.setattr(Trainer, "save_checkpoint", crashing_save)
    with pytest.raises(KeyboardInterrupt):
        _pipeline(tmp_path / "store", train, val)
    monkeypatch.setattr(Trainer, "save_checkpoint", save)
    capsys.readouterr()

    res = _pipeline(tmp_path / "store", train, val, resume=True)
    out = capsys.readouterr().out
    assert "stage 'speech' complete in store" in out and "stage 'rir' complete in store" in out
    assert res["speech"][1] is None and res["rir"][1] is None
    assert len(res["echoed"][1].train["loss"]) == 2  # the remaining 2 of 4 updates
    assert set(res) == set(STAGES)
    want, got = _final_states(tmp_path / "straight"), _final_states(tmp_path / "store")
    for stage in STAGES:
        assert_bitwise(got[stage], want[stage], stage)
        assert_bitwise(dict(res[stage][0]), want[stage]["model"], stage)


def test_pipeline_resume_requires_store():
    with pytest.raises(ValueError, match="store_dir"):
        run_pipeline(0, None, None, resume=True)


def test_pipeline_resume_rejects_flatten_mismatch(datasets, tmp_path):
    """Resuming into a store trained under the other VQ flatten is refused:
    the codebooks are shape-compatible but their codes mean other things."""
    train, _ = datasets
    trainer = Trainer(SpeechVQVAETask(config=SMALL, width_scale=WS, compat_vq_flatten=True), device="cpu",
                      verbose=False, checkpoint_dir=str(tmp_path))
    trainer.fit(train, num_updates=1)  # a complete compat speech stage
    with pytest.raises(ValueError, match="VQ flatten"):
        run_pipeline(7, train, None, store_dir=str(tmp_path), config=SMALL, width_scale=WS, updates=UPDATES,
                     device="cpu", verbose=False, preset="fixed", resume=True)


# ---------------------------------------------------------------- the handoffs


class _Recording(Trainer):
    """A Trainer that keeps itself and its weights at the start of fit."""

    made = {}

    def __init__(self, task, *args, **kw):
        super().__init__(task, *args, **kw)
        self.made[task.name] = self

    def fit(self, *args, **kw):
        self.start_weights = {k: v.clone() for k, v in self.model.state_dict().items()}
        return super().fit(*args, **kw)


@pytest.fixture(scope="module")
def handoffs(datasets, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _Recording.made = {}
        mp.setattr(pipeline, "Trainer", _Recording)
        res = run_pipeline(11, *datasets, store_dir=str(tmp_path_factory.mktemp("handoffs")), config=SMALL,
                           width_scale=WS, updates=UPDATES, preset="fixed", joint_location=True, device="cpu",
                           verbose=False)
    return res, _Recording.made


def _fresh(task, index):
    return Trainer(task, device="cpu", seed=stage_seed(11, index), verbose=False).model.state_dict()


def test_location_reads_the_finetune_final(handoffs):
    res, made = handoffs
    finetune = res["finetune"][0]
    frozen = made["location"].frozen_rir.state_dict()
    assert frozen and all(torch.equal(v, finetune[f"rir_model.{k}"]) for k, v in frozen.items())


def test_echoed_starts_at_the_graft_of_speech_and_rir(handoffs):
    res, made = handoffs
    task = made["echoed"].task
    want = graft_pretrained(_fresh(task, 2), res["speech"][0], res["rir"][0])
    assert_bitwise(made["echoed"].start_weights, want, "echoed start")
    assert_bitwise(made["finetune"].start_weights, dict(res["echoed"][0]), "finetune start")


def test_joint_starts_at_seed_params(handoffs):
    res, made = handoffs
    task = made["location_joint"].task
    assert_bitwise(made["location_joint"].start_weights, task.seed_params(_fresh(task, 5), res["finetune"][0]),
                       "joint start")


def test_run_stage_leaves_the_donor_unchanged(datasets):
    train, _ = datasets
    task = SpeechVQVAETask(config=SMALL, width_scale=WS, batch_size=8)
    donor = Trainer(task, device="cpu", seed=1, verbose=False).model.state_dict()
    before = {k: v.clone() for k, v in donor.items()}
    trainer, history = run_stage(task, 4, train, None, num_updates=3, initial_params=donor, device="cpu",
                                 verbose=False)
    assert len(history.train["loss"]) == 3 and trainer.step_count == 3
    assert_bitwise(donor, before, "donor")
    assert not torch.equal(trainer.model._vq._embedding.weight, donor["_vq._embedding.weight"])


def test_profile_dir_writes_a_trace(datasets, tmp_path):
    """profile_dir traces steps start+2 ... start+7 into <dir>/<task>.json,
    the trainer's spans among its events."""
    task = SpeechVQVAETask(config=SMALL, width_scale=WS, batch_size=8)
    Trainer(task, device="cpu", verbose=False, profile_dir=str(tmp_path)).fit(datasets[0], num_updates=8)
    trace = json.load(open(tmp_path / "speech.json"))
    assert trace["traceEvents"]
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("train.step") == 5 and names.count("train.sample") == 5


# ---------------------------------------------------------------- against the JAX package


class _FakeState:
    params = {"rir_model": {}}
    variables = {}

    def replace(self, **kw):
        return self


def _jax_pipeline_tasks(monkeypatch, **kw):
    """The tasks JAX's run_pipeline builds, recorded without training."""
    tasks = {}

    def run_stage_(task, *a, **k):
        tasks[task.name] = task
        return None, _FakeState(), None

    class FakeTrainer:
        def __init__(self, task, *a, **k):
            tasks[task.name] = task
            self.optimizer = type("Opt", (), {"init": staticmethod(lambda p: None)})

        def init_state(self, *a):
            return _FakeState()

        def fit(self, state, *a, **k):
            return state, None

    monkeypatch.setattr(jpipeline, "run_stage", run_stage_)
    monkeypatch.setattr(jpipeline, "Trainer", FakeTrainer)
    monkeypatch.setattr(jpipeline, "graft_pretrained", lambda *a, **k: {})
    jpipeline.run_pipeline(jax.random.PRNGKey(0), None, None, config=JSMALL, **kw)
    return tasks


def _port_pipeline_tasks(monkeypatch, **kw):
    tasks = {}

    class FakeTrainer:
        def __init__(self, task, *a, **k):
            tasks[task.name] = task
            self.model = type("Model", (), {"state_dict": lambda self: {}, "load_state_dict": lambda self, sd: None})()

        def state_dict(self):  # the handoffs read and write whole tensors through the trainer
            return {}

        def load_state_dict(self, sd):
            pass

        def fit(self, *a, **k):
            return None

    monkeypatch.setattr(pipeline, "Trainer", FakeTrainer)
    run_pipeline(0, None, None, config=SMALL, **kw)
    return tasks


@pytest.mark.parametrize("kw", [
    dict(preset="compat"),
    dict(preset="fixed", vq_ema=True, predict_radius=True, ckpt_every=7,
         joint_task_kwargs={"tail_weight": 0.5, "tail_frac": 0.25}),
    dict(preset="fixed", compat_vq_flatten=True, commitment_weight=0.1, location_input_mode="encodings",
         location_target_mode="sincos"),
], ids=["compat", "fixed", "fixed_overridden"])
def test_pipeline_tasks_match_jax(monkeypatch, kw):
    """Every field of every stage's task (flatten, commitment weight, input
    and target modes, vq_ema, ...) as JAX's run_pipeline builds it."""
    want = _jax_pipeline_tasks(monkeypatch, width_scale=WS, joint_location=True, **kw)
    got = _port_pipeline_tasks(monkeypatch, width_scale=WS, joint_location=True, **kw)
    assert set(got) == set(want) == set(STAGES)
    for name, task in got.items():
        assert type(task).__name__ == type(want[name]).__name__
        for f in dataclasses.fields(task):
            mine, theirs = getattr(task, f.name), getattr(want[name], f.name)
            if f.name == "config":
                mine, theirs = mine.to_reference_dict(), theirs.to_reference_dict()
            assert mine == theirs, (name, f.name, mine, theirs)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(model, *inputs, seed=0):
    return _np(model.init({"params": jax.random.PRNGKey(seed), "jitter": jax.random.PRNGKey(seed + 1)},
                          *inputs)["params"])


def _latent_rows(branch, x, seed):
    """K pre-VQ latent rows of ``x`` as the branch's quantizer sees them: a
    codebook without near ties, so JAX and the port pick the same codes."""
    with torch.no_grad():
        z = branch.pre_vq_latent(x)
        rows = (z if branch.compat_vq_flatten else z.transpose(1, 2)).reshape(-1, branch.embedding_dim)
    pick = np.random.default_rng(seed).choice(rows.shape[0], branch.num_embeddings, replace=False)
    return np.ascontiguousarray(rows.numpy()[pick])


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("input_mode,target_mode,flatten", [("encodings", "normalized_angle", True),
                                                            ("quantized", "sincos", False)])
def test_evaluate_location_matches_jax(input_mode, target_mode, flatten):
    """The frozen localizer's metrics on the same weights (a grafted JAX
    composite, a JAX head, carried by composite_params_from_jax and
    params_from_jax) and the same 70 samples, in chunks of 64."""
    kw = dict(config=JSMALL, width_scale=WS, compat_vq_flatten=flatten)
    x, x_rir = jnp.zeros((1, F, T)), jnp.zeros((1, T, F))
    comp = _init(jtrain.EchoedSpeechTask(**kw).build_model(), x, x_rir)
    speech_p = _init(jtrain.SpeechVQVAETask(**kw).build_model(), x, seed=2)
    rir_p = _init(jtrain.RirVQVAETask(**kw).build_model(), x_rir, seed=4)
    comp_p = _np(jtrain.graft_pretrained(comp, speech_p, rir_p))
    task = LocationTask(config=SMALL, width_scale=WS, input_mode=input_mode, target_mode=target_mode,
                        compat_vq_flatten=flatten)
    d = _arrays(70, 40)
    rir = task.build_frozen(composite_params_from_jax(comp_p), torch.device("cpu"))
    x = znorm(torch.from_numpy(d["echoed_spec"][:8]), dim=1).transpose(1, 2)
    comp_p["rir_model"]["_vq"]["codebook"] = _latent_rows(rir, x, 12)
    jtask = jtrain.LocationTask(input_mode=input_mode, target_mode=target_mode, **kw)
    head_p = _init(jtask.build_model(), jnp.zeros((1, F, task.feature_width)), seed=9)
    want = jeval.evaluate_location(jtask, jax.tree_util.tree_map(jnp.asarray, head_p),
                                   jax.tree_util.tree_map(jnp.asarray, comp_p), _jax_batch(d))
    head = params_from_jax(head_p)
    got = evaluate_location(task, head, composite_params_from_jax(comp_p), _torch_batch(d), device="cpu")
    _assert_metrics_match(got, want)
    assert infer_location_modes(head, task) == {"input_mode": input_mode, "target_mode": target_mode}
    both = compare_location_models(
        {"a": {"location_params": head, "composite_params": composite_params_from_jax(comp_p)}},
        _torch_batch(d), task, device="cpu")
    assert both == {"a": got}


@pytest.mark.parametrize("kw", [dict(predict_radius=True, tail_weight=0.5), dict(target_mode="normalized_angle")],
                         ids=["sincos_radius", "angle"])
def test_evaluate_joint_location_matches_jax(kw):
    """The joint localizer's metrics, the radius ones included, on the same
    weights and the same 70 samples."""
    jtask = jtrain.JointLocationTask(config=JSMALL, width_scale=WS, **kw)
    p = _init(jtask.build_model(), jnp.zeros((1, T, F)), seed=12)
    task = JointLocationTask(config=SMALL, width_scale=WS, **kw)
    model = task.build_model()
    model.load_state_dict(params_from_jax(p))
    d = _arrays(70, 41)
    (x,) = task.model_inputs(torch.from_numpy(d["echoed_spec"][:8]))
    p["rir_model"]["_vq"]["codebook"] = _latent_rows(model.rir_model, x, 14)
    want = jeval.evaluate_joint_location(jtask, jax.tree_util.tree_map(jnp.asarray, p), _jax_batch(d))
    got = evaluate_joint_location(task, params_from_jax(p), _torch_batch(d), device="cpu")
    _assert_metrics_match(got, want)
    assert infer_target_mode(params_from_jax(p)) == jeval.infer_target_mode(p["head"])


def test_save_dataset_is_read_by_both_packages(tmp_path):
    """The port's save_dataset writes the JAX layout: the JAX SpecsDataset
    and the port's read back the same arrays and config."""
    d = _arrays(5, 50)
    save_dataset(str(tmp_path), _torch_batch(d), SMALL)
    port, jax_ds = SpecsDataset(str(tmp_path)), JaxSpecsDataset(str(tmp_path))
    assert port.config == SMALL and jax_ds.config == JSMALL
    got, want = port.load_all(), jax_ds.load_all()
    for k, v in d.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(want, k)), v, err_msg=k)
