"""The port's host-staged training and ``Trainer(optimizer=)`` on the CPU,
against the JAX package where the JAX package has the same function.

* ``HostStagedDataset.chunk`` and ``num_chunks`` bitwise JAX's on one numpy
  batch (32 rows in chunks of 8, and 10 in chunks of 4 with the sliding
  tail, as JAX's ``tests/test_scale.py:70-104``);
* ``make_host_dataset`` bitwise ``make_dataset`` moved to the CPU;
* the rotation schedule step for step JAX's on an uninterrupted run: which
  chunk each step samples and at which step each chunk is fetched (the
  prefetch offset), with the steps themselves replaced on both sides;
* host-staged with ``chunk_size >= size`` bitwise the resident run, a
  cached echoed run bitwise a control that swaps the chunks by hand, and a
  run preempted mid-window and resumed bitwise the uninterrupted one (JAX
  restarts at chunk 0 after a resume; the port follows the step); a CUDA
  trainer refuses a host set that is not pinned;
* ``optimizer=``: the default bitwise an explicit Adam factory; AdamW keeps
  the frozen-latent cache valid (torch's optimizers skip a parameter without
  a gradient, weight decay included); an optimizer that decays every
  parameter it holds trips the frozen-weight guard with JAX's message; the
  model-parallel checkpoint refuses optimizer state of another shape.

Widths are cut to 1/32 and the spectrograms to 16 frames; every comparison
is bitwise (the functions are copies, or the same arithmetic in another
order of calls).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from acoustic_locating_vq_vae_torch import data as D
from acoustic_locating_vq_vae_torch.train import EchoedSpeechTask, Preempted, SpeechVQVAETask, Trainer

WS = 1 / 32
T = 16
SMALL = dict(n_sample=512, audio_samples=3200, num_frames=100, NFFT=64, HOP_LENGTH=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU ops run faster on one thread, alone and beside the
    suite's other workers; the setting comes back after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arrays(n: int, f: int = 201, t: int = T, seed: int = 0) -> dict:
    """A numpy batch of ``n`` rows, theta = the row's index."""
    rng = np.random.default_rng(seed)
    spec = lambda: rng.exponential(1.0, (n, f, t)).astype(np.float32)
    return dict(speech_spec=spec(), rir_spec=spec(), echoed_spec=spec(), fs=np.full(n, 16000, np.int64),
                theta=np.arange(n, dtype=np.float32), wiener_est=rng.random((n, f), np.float32),
                radius=np.ones(n, np.float32))


def _batch(arrays: dict) -> D.SampleBatch:
    return D.SampleBatch(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _same_state(a: Trainer, b: Trainer) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _speech_task(**kw):
    return SpeechVQVAETask(**{"width_scale": WS, "batch_size": 4, **kw})


# ---------------------------------------------------------------- the dataset


@pytest.mark.parametrize("size,chunk", [(32, 8), (10, 4)])
def test_chunks_match_jax(size, chunk):
    """Every chunk's rows (cyclic, the tail window slid back) and the chunk
    count equal JAX's on the same numpy batch."""
    from acoustic_locating_vq_vae_tpu.data import SampleBatch as JaxBatch
    from acoustic_locating_vq_vae_tpu.data.dataset import HostStagedDataset as JaxHost

    arrays = _arrays(size, t=4)
    mine = D.HostStagedDataset(_batch(arrays), chunk, rotate_every=5)
    theirs = JaxHost(JaxBatch(**arrays), chunk, rotate_every=5)
    assert (mine.size, mine.chunk_size, mine.num_chunks) == (theirs.size, theirs.chunk_size, theirs.num_chunks)
    for i in range(2 * mine.num_chunks + 1):
        for k in D.SampleBatch._fields:
            np.testing.assert_array_equal(getattr(mine.chunk(i), k).numpy(), np.asarray(getattr(theirs.chunk(i), k)))
    for bad in (0, -3):
        with pytest.raises(ValueError, match="chunk_size must be positive"):
            D.HostStagedDataset(_batch(arrays), bad)
        with pytest.raises(ValueError, match="chunk_size must be positive"):
            JaxHost(JaxBatch(**arrays), bad)


def test_make_host_dataset_is_make_dataset():
    """The host set is bitwise make_dataset's from the same generator, with
    pruning and bf16 storage too; chunk(i) are views of it."""
    cfg = D.DatasetConfig(**SMALL)
    for kw in ({}, {"keep_fields": ("speech_spec",), "store_dtype": torch.bfloat16}):
        want = D.make_dataset(torch.Generator().manual_seed(5), 6, cfg, batch=4, device="cpu", rir_chunk=2048, **kw)
        host = D.make_host_dataset(torch.Generator().manual_seed(5), 6, cfg, batch=4, chunk_size=4, rotate_every=2,
                                   device="cpu", rir_chunk=2048, **kw)
        assert _same(host.arrays, want), kw
        assert host.num_chunks == 2 and host.chunk(1).speech_spec.data_ptr() == host.arrays.speech_spec[2].data_ptr()


# ---------------------------------------------------------------- the schedule


def _jax_schedule(arrays, chunk, every, steps):
    """JAX's fit over a host-staged set with its steps replaced: the rows
    each step saw, and (step, index) of every chunk(index) call."""
    import jax.numpy as jnp

    from acoustic_locating_vq_vae_tpu.data import SampleBatch as JaxBatch
    from acoustic_locating_vq_vae_tpu.data.dataset import HostStagedDataset as JaxHost
    from acoustic_locating_vq_vae_tpu.train import SpeechVQVAETask as JaxSpeech
    from acoustic_locating_vq_vae_tpu.train import Trainer as JaxTrainer

    seen, calls = [], []

    class Recorded(JaxHost):
        def chunk(self, i):
            calls.append((len(seen), i))
            return super().chunk(i)

    tr = JaxTrainer(JaxSpeech(width_scale=WS, batch_size=2), verbose=False)

    def step(state, op, n, train):
        seen.append(tuple(np.asarray(op.theta).tolist()))
        return state, {"loss": jnp.zeros(())}

    tr._step_fn = step
    tr.fit(SimpleNamespace(params=jnp.zeros(())), Recorded(JaxBatch(**arrays), chunk, every), None, num_updates=steps)
    return seen, calls


def _port_schedule(arrays, chunk, every, steps):
    """The port's fit with its sampling and steps replaced: the same records,
    and each step's resident chunk index."""
    seen, calls, resident = [], [], []

    class Recorded(D.HostStagedDataset):
        def chunk(self, i):
            calls.append((len(seen), i))
            return super().chunk(i)

    tr = Trainer(_speech_task(batch_size=2), device="cpu", verbose=False)

    def sample(data):
        seen.append(tuple(data.theta.tolist()))
        resident.append(tr.resident_chunk)
        return data

    tr.sample = sample
    tr.step = lambda batch, train=True, cache=None: {"loss": torch.zeros(())}
    tr.fit(Recorded(_batch(arrays), chunk, every), None, num_updates=steps)
    return seen, calls, resident


@pytest.mark.parametrize("size,chunk,every,steps", [(32, 8, 4, 19), (10, 4, 3, 11), (12, 4, 1, 5)])
def test_rotation_schedule_follows_jax(size, chunk, every, steps):
    """On an uninterrupted run the port samples from the chunk JAX samples
    from at every step, and fetches each chunk at JAX's step (the prefetch
    from max(1, (R + 1) // 2) steps into a window; every step at R = 1)."""
    arrays = _arrays(size, t=4)
    want_seen, want_calls = _jax_schedule(arrays, chunk, every, steps)
    seen, calls, resident = _port_schedule(arrays, chunk, every, steps)
    assert seen == want_seen
    assert calls == want_calls
    n = -(-size // chunk)
    assert resident == [(i // every) % n for i in range(steps)]


# ---------------------------------------------------------------- training


def test_one_chunk_is_the_resident_run(capsys):
    """chunk_size >= size: bitwise the resident run (weights and metrics),
    and the chunk is never copied again; JAX's verbose line."""
    b = _batch(_arrays(12))
    ref = Trainer(_speech_task(), device="cpu", seed=1, verbose=False)
    h_ref = ref.fit(b, num_updates=5)
    tr = Trainer(_speech_task(), device="cpu", seed=1, verbose=True, log_every=100)
    h = tr.fit(D.HostStagedDataset(b, 20, rotate_every=2), num_updates=5)
    assert "[speech] host-staged dataset: 12 rows, 1 chunks of 12 resident, rotating every 2 steps" in (
        capsys.readouterr().out)
    assert _same_state(tr, ref)
    for k, v in h_ref.train.items():
        assert all(torch.equal(x, y) for x, y in zip(v, h.train[k])), k


def _echoed_task(**kw):
    return EchoedSpeechTask(config=D.DatasetConfig(**SMALL), width_scale=WS, batch_size=4, compat_vq_flatten=False,
                            **kw)


def test_cached_echoed_rotations_are_a_swapped_resident_run():
    """The echoed stage from its cache over rotating chunks is bitwise a
    resident trainer whose set and cache are swapped by hand at the same
    steps (the cache rebuilt for each new chunk)."""
    cfg = D.DatasetConfig(**SMALL)
    b = _batch(_arrays(12, cfg.num_freq, cfg.num_frames, seed=3))
    host = D.HostStagedDataset(b, 4, rotate_every=2)
    tr = Trainer(_echoed_task(), device="cpu", seed=2, verbose=False, cache_frozen=True)
    h = tr.fit(host, num_updates=7)
    ref = Trainer(_echoed_task(), device="cpu", seed=2, verbose=False, cache_frozen=True)
    losses = []
    for i in range(7):
        if i % 2 == 0:
            data = host.chunk(i // 2).map(torch.clone)
            cache = ref.build_cache(data)
        batch, rows = ref.sample_cached(data, cache)
        losses.append(ref.step(batch, cache=rows)["loss"])
    assert _same_state(tr, ref)
    assert all(torch.equal(a, b) for a, b in zip(h.train["loss"], losses))


def test_resume_mid_window_is_the_uninterrupted_run(tmp_path):
    """Preempted in the middle of a window (after the prefetch offset) and
    resumed from the store: the resumed run holds the uninterrupted run's
    chunk at every step and ends bitwise equal to it."""
    arrays = _arrays(16)
    task = _speech_task(ckpt_every=100)
    whole = Trainer(task, device="cpu", seed=4, verbose=False)
    whole.fit(D.HostStagedDataset(_batch(arrays), 4, rotate_every=4), num_updates=11)
    cut = Trainer(task, device="cpu", seed=4, verbose=False, checkpoint_dir=str(tmp_path))
    step = cut.step

    def step_then_stop(*args, **kwargs):
        out = step(*args, **kwargs)
        if cut.step_count == 6:  # window 1, offset 2 = the prefetch offset of R = 4
            cut.request_preemption()
        return out

    cut.step = step_then_stop
    with pytest.raises(Preempted):
        cut.fit(D.HostStagedDataset(_batch(arrays), 4, rotate_every=4), num_updates=11)
    resumed = Trainer(task, device="cpu", seed=4, verbose=False, checkpoint_dir=str(tmp_path))
    chunks = []
    step2 = resumed.step

    def record(*args, **kwargs):
        chunks.append(resumed.resident_chunk)
        return step2(*args, **kwargs)

    resumed.step = record
    resumed.fit(D.HostStagedDataset(_batch(arrays), 4, rotate_every=4), num_updates=11, resume=True)
    assert chunks == [(i // 4) % 4 for i in range(6, 11)]
    assert _same_state(resumed, whole)


def test_cuda_trainer_refuses_a_pageable_host_set():
    """A non_blocking copy from pageable memory is synchronous: the prefetch
    would not overlap, so a CUDA trainer raises before it makes a stream."""
    from acoustic_locating_vq_vae_torch.train.loop import _ChunkStager

    card = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="must be in pinned memory"):
        _ChunkStager(card, D.HostStagedDataset(_batch(_arrays(8)), 4))


def test_host_staged_with_on_the_fly_raises():
    b = _batch(_arrays(8))
    tr = Trainer(_speech_task(), device="cpu", verbose=False, on_the_fly=True)
    with pytest.raises(ValueError, match="host-staged train data is pointless with on_the_fly"):
        tr.fit(D.HostStagedDataset(b, 4), b, num_updates=1)


# ---------------------------------------------------------------- optimizer=


def test_default_optimizer_is_an_adam_factory():
    b = _batch(_arrays(8))
    ref = Trainer(_speech_task(), device="cpu", seed=6, verbose=False)
    ref.fit(b, num_updates=3)
    tr = Trainer(_speech_task(), device="cpu", seed=6, verbose=False,
                 optimizer=lambda p: torch.optim.Adam(p, lr=_speech_task().learning_rate))
    tr.fit(b, num_updates=3)
    assert _same_state(tr, ref)
    assert ref._default_optimizer and not tr._default_optimizer


class DecayAll(torch.optim.Optimizer):
    """Shrinks every parameter it holds each step, with a gradient or without."""

    def __init__(self, params, lr=1e-3, decay=1e-2):
        super().__init__(params, dict(lr=lr, decay=decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                p.mul_(1 - group["decay"])
                if p.grad is not None:
                    p.add_(p.grad, alpha=-group["lr"])


# JAX train/loop.py:770-777
JAX_MESSAGE = ("cache_frozen=True but frozen subtree 'rir_model' changed during training: the supplied optimizer "
               "does not map zero grads to zero updates (e.g. weight decay), so the frozen-latent cache is stale.")


def test_frozen_weight_guard():
    """AdamW (decay 0.1) leaves the cached branches bitwise unchanged and
    trains; an optimizer that decays every parameter trips the guard with
    JAX's message; without the cache nothing is checked."""
    cfg = D.DatasetConfig(**SMALL)
    b = _batch(_arrays(8, cfg.num_freq, cfg.num_frames, seed=7))
    adamw = Trainer(_echoed_task(), device="cpu", seed=8, verbose=False, cache_frozen=True,
                    optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=0.1))
    before = adamw._frozen_fingerprint()
    adamw.fit(b, num_updates=2)
    after = adamw._frozen_fingerprint()
    assert set(before) == {"rir_model", "speech_model"}
    assert all(torch.equal(before[m][k], after[m][k]) for m in before for k in before[m])
    decay = Trainer(_echoed_task(), device="cpu", seed=8, verbose=False, cache_frozen=True, optimizer=DecayAll)
    with pytest.raises(RuntimeError) as err:
        decay.fit(b, num_updates=2)
    assert str(err.value).startswith(JAX_MESSAGE)
    Trainer(_echoed_task(), device="cpu", seed=8, verbose=False, optimizer=DecayAll).fit(b, num_updates=1)


def test_model_parallel_state_must_have_the_parameters_shape():
    """A split parameter's optimizer state is gathered and cut by the
    parameter's shape; state of another shape raises."""
    from acoustic_locating_vq_vae_torch.parallel.tensor import _split_state

    shard = SimpleNamespace(dim=0, full=8, gather=lambda v: torch.cat([v, v]), take=lambda v: v[:4])
    p = torch.zeros(4, 3)
    st = {"step": torch.tensor(2.0), "exp_avg": torch.ones(4, 3)}
    out = _split_state(st, p, shard, whole=False)
    assert out["exp_avg"].shape == (8, 3) and out["step"] is st["step"]
    assert _split_state({"exp_avg": torch.ones(8, 3)}, p, shard, whole=True)["exp_avg"].shape == (4, 3)
    with pytest.raises(ValueError, match="per-parameter state of the parameter's shape"):
        _split_state({"factored_row": torch.ones(4)}, p, shard, whole=False)
    assert _split_state(st, p, None, whole=False) is st
