"""The training loop of every stage.

Counterpart of ``acoustic_locating_vq_vae_tpu/train/loop.py``: ``Preempted``
(:47-62), ``TrainHistory`` (:89-130), the ``Trainer``'s state, optimizer and
frozen composite (:133-319), its step (:423-475), ``request_preemption`` and
``fit`` (:502-737), on-the-fly synthesis (:150-190, :477-500), host-staged
data (:557-575, :657-697), the resident field check (:739-753), the
frozen-weight guard (:198-212, :619-620, :755-781), the frozen-latent cache
(:609-633, :783-813) and the checkpoints (:817-918):

* the dataset is resident on the trainer's device; each step samples a fresh
  batch without replacement (the reference's fresh-shuffle
  ``next(iter(loader))``, train_speech.py:57-61) from an explicit CPU
  generator, and bf16-stored arrays are cast to float32 per batch;
* with ``on_the_fly`` each train step synthesizes a fresh batch on the
  device instead (``data.synthesize_batch`` with ``synth_kwargs``, from a
  synthesis generator on the trainer's device); a RIR bank and a speech pool
  in ``synth_kwargs`` are moved to the device once, when the trainer is made
  or :meth:`Trainer.set_synthesis` is called, and the training set is unused
  (it may be None); eval steps still sample the resident validation set;
* a :class:`..data.HostStagedDataset` as the training set stays in host
  memory: the trainer holds one chunk of it on the device (this rank's block
  of it under a mesh), samples from it with the unchanged sampler, and at
  step ``i`` holds chunk ``i // rotate_every`` (cyclic), so a run rotates at
  steps R, 2R, ... as JAX's does. From step ``max(1, (R + 1) // 2)`` of a
  window it copies the next chunk from pinned memory on a side CUDA stream
  (``non_blocking``; a CUDA trainer refuses a set that is not pinned, whose
  copies would be synchronous); at the rotation the compute stream waits on that copy's
  event, and the chunk's tensors are recorded on the compute stream, so
  their memory is not reused while a queued step still reads them. The
  device holds two chunks at most. The schedule is a function of the step,
  so a resume holds the chunk the uninterrupted run held (JAX restarts at
  chunk 0); a rotation to the chunk already held (one chunk in all) keeps it;
  with ``cache_frozen`` each new chunk's cache is built at its rotation;
* a train step runs the task's loss, its backward and one optimizer update:
  by default ``torch.optim.Adam(lr)`` (the same update as ``optax.adam(lr)``,
  eps 1e-8 outside the square root, bias-corrected), or the ``optimizer``
  factory's. A frozen parameter ends the step with no gradient, which torch's
  optimizers skip (weight decay included): the exact zero update that optax
  gives a zero gradient. With a supplied optimizer and the cache, ``fit``
  still checks that the cached branches' weights stayed bitwise constant, as
  JAX's does;
* a stage that reads a frozen module outside its model gets it from its task
  (``Task.build_frozen``: the location stage's RIR branch of
  ``composite_params``), held in eval mode outside the optimizer; the task's
  ``step_loss`` and ``step_cache`` are the trainer's one loss path and one
  cache path;
* with ``cache_frozen``, a task with a frozen path (``supports_cache``)
  trains from its frozen branches' code ids, computed once per resident
  dataset and sampled with their rows (under ``on_the_fly`` only the
  validation set's: synthesized batches run the frozen branches);
* with ``val_replaces_train`` every ``eval_every``-th step is an eval step
  that takes the place of a train step (train_speech.py:57,76-87);
* the trainer counts its steps (``step_count``, the JAX ``state.step``, eval steps
  included); ``fit`` runs from it up to ``num_updates``. With a store
  (``checkpoint_dir``) it saves a periodic checkpoint every
  ``task.ckpt_every`` steps and a final one at the end; a checkpoint holds
  the model's state dict (EMA buffers included), Adam's state dict, the step
  and the states of both CPU generators (and under ``on_the_fly`` of the
  synthesis generator), so a resumed run draws the same batches and jitter
  decisions as an uninterrupted one and its steps are bitwise the same;
* SIGTERM during ``fit`` saves a checkpoint at the next step boundary and
  raises :class:`Preempted`; ``fit(resume=True)`` continues from the newest
  periodic checkpoint;
* ``profile_dir`` traces steady-state steps with ``torch.profiler``, the
  program's spans among them (``utils/profiling.py:span``);
* with ``mesh`` (a :class:`..parallel.DataParallel` handle; JAX
  :196-212, :359-420) every rank trains on its block of the global batch:
  it holds its contiguous block of each resident set and draws ``B / W``
  rows of it (stratified sampling, its sampling generator seeded from
  ``seed + 1`` with the rank folded in), or, where the batch or the set does
  not divide by the world size W, holds the whole set and keeps its block of
  global indices drawn from a generator shared by every rank (with a
  warning); on-the-fly it synthesizes its block from a synthesis generator
  with the rank folded in. Every rank draws the weights from ``seed``
  (checked bitwise at construction) and the jitter decisions from the same
  generator. A step reduces the vector quantizers' statistics, the
  gradients and the metrics over the ranks (``parallel/dp_step.py``), so it
  is the global batch's step; rank 0 alone writes checkpoints, which carry
  every rank's generators (a resume at another world size raises), and a
  SIGTERM on any rank stops every rank at the same step boundary;
* convolutions and matrix products run in full float32 (TF32 off), the
  convolutions with cuDNN's deterministic algorithms (``utils/device.py``);
  a task with ``compute_dtype="bfloat16"`` runs its conv stacks in bf16 under
  the same deterministic pin (cuDNN raises where it has no deterministic
  algorithm; nothing falls back to float32), while the parameters, Adam's
  state, the checkpoints, the cache's codes and the losses stay float32.

* with a process ``mesh`` (``parallel.make_mesh``; JAX :143, :197-209,
  :280-290, :317-356) the data axis is the data parallelism above, its data
  coordinate folded into the sampling and synthesis seeds, so every model and
  sequence rank of one data row draws the same batch; a task with a
  ``sequence_axis`` runs each step on the rank's window of the time axis of
  every 3-D batch field, its convs exchanging halos (``parallel/sequence.py``),
  and the gradients and metrics are averaged over that axis as well (the
  frozen-latent cache is not used there, as in JAX); with ``model_parallel``
  the large parameters are split over the model axis by the partition rules
  (``parallel/tensor.py``), each rank holding its block of them and of Adam's
  state. A checkpoint holds whole tensors whatever the split, so a store
  written under one model axis size resumes under another.
"""

from __future__ import annotations

import contextlib
import signal
import time
import warnings
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data.dataset import HostStagedDataset, sample_without_replacement
from ..data.synth import SampleBatch, synthesize_batch
from ..ops.jitter import Jitter
from ..models.conv_vqvae import sequence_sharding
from ..ops.vq import global_statistics
from ..parallel.dp_step import make_dp_train_step, reduce_metrics, step_weight
from ..parallel.mesh import AXES, DataParallel, check_replicated, rank_seed, shard_batch
from ..parallel.tensor import (
    full_optimizer_state, full_state_dict, shard_model, shard_optimizer_state, shard_state_dict,
)
from ..utils.checkpoint import StageStore
from ..utils.device import deterministic_convs, full_fp32, resolve_device
from ..utils.profiling import span, trace
from .tasks import Task, resolved_vq_flatten

Cache = Dict[str, torch.Tensor]
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]

__all__ = ["Trainer", "TrainHistory", "Preempted", "checkpoint_metadata"]

# metadata attributes a checkpoint records where the task has them: the
# evaluation-relevant configuration, which the VQ flatten is without a shape
_META_ATTRS = ("compat_vq_flatten", "input_mode", "target_mode", "predict_radius")


def checkpoint_metadata(task, final: bool) -> dict:
    """The metadata a checkpoint of ``task`` records in the store's manifest:
    the task's name, whether the checkpoint is the stage's final one, and
    the evaluation-relevant modes the task has (``_META_ATTRS``), which the
    deploy entry points read back (``cli.common.apply_stage_eval_config``)."""
    meta: dict = {"task": task.name, "final": final, "has_rng": True}
    for attr in _META_ATTRS:
        if hasattr(task, attr):
            v = getattr(task, attr)
            if attr == "compat_vq_flatten":
                v = resolved_vq_flatten(task)  # as the task's build_model resolves it
            meta[attr] = v
    return meta


class Preempted(RuntimeError):
    """Raised by :meth:`Trainer.fit` when a preemption signal (SIGTERM)
    arrives mid-stage: the loop saves a periodic checkpoint first, so
    restarting with ``resume=True`` (or the pipeline CLI's ``--resume``)
    loses at most the in-flight step."""

    def __init__(self, task: str, completed: int):
        super().__init__(
            f"stage {task!r} preempted after {completed} updates; checkpoint "
            "saved — restart with resume=True / --resume to continue"
        )
        self.task = task
        self.completed = completed


class TrainHistory:
    """Append-only metric history with reference-style running means
    (print of mean over last 100, train_speech.py:96-103). Values are kept as
    0-d tensors where they were made, so appending does not wait for the card."""

    def __init__(self):
        self.train: Dict[str, List] = {}
        self.val: Dict[str, List] = {}

    def append(self, metrics: Dict[str, torch.Tensor], val: bool):
        store = self.val if val else self.train
        for k, v in metrics.items():
            store.setdefault(k, []).append(v)

    def running_mean(self, key: str, window: int = 100) -> float:
        vals = self.train.get(key, [])
        if not vals:
            return float("nan")
        return float(np.mean([float(v) for v in vals[-window:]]))

    def finalize(self) -> Dict[str, Dict[str, np.ndarray]]:
        as_np = lambda vs: np.asarray([float(v) for v in vs], np.float32)
        return {
            "train": {k: as_np(v) for k, v in self.train.items()},
            "val": {k: as_np(v) for k, v in self.val.items()},
        }

    def save(self, path: str) -> None:
        """Persist metric histories as one .npz of ``<split>/<metric>`` arrays,
        the JAX package's layout."""
        flat = {}
        for split, metrics in self.finalize().items():
            for k, v in metrics.items():
                flat[f"{split}/{k}"] = v
        np.savez(path, **flat)

    @staticmethod
    def load(path: str) -> Dict[str, Dict[str, np.ndarray]]:
        d = np.load(path)
        out: Dict[str, Dict[str, np.ndarray]] = {"train": {}, "val": {}}
        for key in d.files:
            split, name = key.split("/", 1)
            out[split][name] = d[key]
        return out


class Trainer:
    """Trainer for a :class:`..train.tasks.Task` on one device.

    The weights are drawn from ``seed`` on the CPU and moved to ``device``,
    so a run on the card and one on the CPU start alike; batch sampling and
    jitter decisions come from their own CPU generators seeded from
    ``seed + 1`` and ``seed + 2``, on-the-fly synthesis from a generator on
    ``device`` seeded from ``seed + 3``. Runs on the card unless
    ``device="cpu"``; raises if a card is asked for and none is present.

    ``on_the_fly`` synthesizes every train step's batch (see
    :meth:`otf_batch`); ``synth_kwargs`` are its ``synthesize_batch``
    options, with ``rir_bank`` and ``speech_pool`` (n, audio_samples) held on
    the device. Both of those are refused without ``on_the_fly``: a resident
    set draws them when it is made (``make_dataset``).

    ``composite_params`` is the state dict of the composite whose RIR branch
    feeds a :class:`LocationTask` (train_location.py:38,69), required there;
    the trainer holds that branch alone (``frozen_rir``), as the reference
    reads only ``composite_params["rir_model"]``.
    ``cache_frozen`` trains a task with a frozen path from its cached codes
    (see :meth:`build_cache`); it is ignored for a task without one.
    ``checkpoint_dir`` is a :class:`StageStore` root for the stage's
    checkpoints; ``keep_checkpoints`` > 0 keeps only the newest N periodic
    ones (finals are kept). ``profile_dir`` traces steps ``start + 2`` to
    ``start + 7`` of :meth:`fit` into ``<profile_dir>/<task name>.json``.

    ``optimizer`` is a factory that binds a torch optimizer to the
    parameters the trainer builds (default ``torch.optim.Adam(params,
    lr=task.learning_rate)``). Under ``model_parallel`` its per-parameter
    state tensors must have their parameter's shape (Adam, AdamW), since a
    checkpoint gathers them whole.

    ``mesh`` (a handle of ``parallel.init_data_parallel`` or
    ``parallel.make_mesh``) trains this rank's share of every batch over its
    data axis (see the module docstring), shards the time axis of a task with
    a ``sequence_axis`` over its sequence axis, and with ``model_parallel``
    splits the large parameters over its model axis; the trainer runs on the
    handle's device (``device`` must name the same type), only the mesh's
    first rank prints, profiles and writes checkpoints, and a handle without a
    group (``parallel.local_mesh``) is the same as none."""

    def __init__(
        self,
        task: Task,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
        log_every: int = 100,
        val_replaces_train: bool = True,
        verbose: bool = True,
        composite_params: Optional[Mapping[str, torch.Tensor]] = None,
        cache_frozen: bool = False,
        checkpoint_dir: Optional[str] = None,
        keep_checkpoints: int = 0,
        profile_dir: Optional[str] = None,
        on_the_fly: bool = False,
        synth_kwargs: Optional[Mapping] = None,
        mesh: Optional[DataParallel] = None,
        model_parallel: bool = False,
        optimizer: Optional[OptimizerFactory] = None,
    ):
        self.task = task
        self.dp = mesh if mesh is not None and mesh.distributed else None
        # the sequence axis comes from the task (JAX loop.py:207-209)
        self.seq_axis = getattr(task, "sequence_axis", None)
        if self.seq_axis is not None and self.seq_axis not in AXES:
            raise ValueError(f"mesh has no axis {self.seq_axis!r} for sequence parallelism")
        rank, self.world_size = (self.dp.rank, self.dp.world_size) if self.dp else (0, 1)
        if self.dp is not None:
            if torch.device(device).type != self.dp.device.type:
                raise ValueError(f"device {device} is not the data-parallel rank's device {self.dp.device}")
            device = self.dp.device
        self.device = resolve_device(device)
        self.on_the_fly = on_the_fly
        self.set_synthesis(synth_kwargs)
        self.frozen_rir = task.build_frozen(composite_params, self.device)
        self.model = task.build_model(torch.Generator().manual_seed(seed)).to(self.device).train()
        # the sampling and synthesis streams fold the rank in (rank 0's are the single-process ones); the
        # jitter decisions are shared by every rank, as the batch-shared jitter needs
        self.sample_generator = torch.Generator().manual_seed(rank_seed(seed + 1, rank))
        self.shared_sample_generator = torch.Generator().manual_seed(seed + 1) if self.dp else None
        self.jitter_generator = torch.Generator().manual_seed(seed + 2)
        self.synth_generator = (torch.Generator(self.device).manual_seed(rank_seed(seed + 3, rank))
                                if on_the_fly else None)
        self.step_count = 0  # steps taken, eval steps included (the JAX state.step)
        self.log_every = log_every
        self.val_replaces_train = val_replaces_train
        lead = self.dp is None or self.dp.lead
        self.verbose = verbose and lead
        # a time shard's frozen branches are not cached (the JAX trainer ignores the cache there too)
        self.cache_frozen = cache_frozen and not self._seq_sharded
        self.store = StageStore(checkpoint_dir) if checkpoint_dir else None
        self.keep_checkpoints = int(keep_checkpoints)
        self.profile_dir = profile_dir if lead else None
        if self.dp is not None:
            if self.world_size > 1 and any(m.per_batch for m in self.model.modules() if isinstance(m, Jitter)):
                raise NotImplementedError("per-sample jitter under data parallelism would draw each rank's decisions "
                                          "apart from the global batch's; the compat batch-shared jitter is supported")
            check_replicated(self.model, self.dp)
            if self.frozen_rir is not None:
                check_replicated(self.frozen_rir, self.dp, "frozen weights")
        if model_parallel:
            shard_model(self.model, self.dp)
        # model.parameters() yields a tied residual block once, so the
        # optimizer's state, keyed by parameter order, is the same for every
        # trainer of the task. The cache assumes zero updates for the frozen
        # branches, which Adam gives; a supplied optimizer is checked (fit).
        self._default_optimizer = optimizer is None
        params = self.model.parameters()
        self.optimizer = (torch.optim.Adam(params, lr=task.learning_rate) if optimizer is None
                          else optimizer(params))
        if self.dp is not None:
            # the explicit-collective step (parallel/dp_step.py), on a (batch, cache rows) pair
            self._dp_step = make_dp_train_step(lambda bc: self._loss(bc[0], True, bc[1]), self.optimizer, self.dp)
        # set by the SIGTERM handler fit() installs, or request_preemption()
        self._preempt_requested = False
        # while fit runs: the rows of each set it holds (its speech_spec's id) -> the whole set's rows
        self._held: Dict[int, int] = {}
        # the chunk of a host-staged set that fit holds (its index mod the chunk count), else None
        self.resident_chunk: Optional[int] = None

    @property
    def _seq_sharded(self) -> bool:
        """Whether steps run on time shards: the task names a sequence axis
        and the mesh's has more than one rank."""
        return self.seq_axis is not None and self.dp is not None and self.dp.axis(self.seq_axis)[2] > 1

    def _time_window(self, batch: SampleBatch) -> SampleBatch:
        """This rank's window of the time axis (the last) of every 3-D field
        of ``batch``, the JAX ``P("data", None, "seq")`` layout."""
        _, s, n = self.dp.axis(self.seq_axis)

        def window(a):
            if a.dim() != 3:
                return a
            if a.shape[-1] % n:
                raise ValueError(f"sequence length {a.shape[-1]} not divisible by {self.seq_axis}={n}")
            per = a.shape[-1] // n
            return a[..., s * per:(s + 1) * per]

        return batch.map(window)

    def set_synthesis(self, synth_kwargs: Optional[Mapping]) -> None:
        """Set the on-the-fly synthesis options (``synth_kwargs`` of the
        constructor): the RIR bank and the speech pool go to the device now,
        once, and every later :meth:`otf_batch` reads them there. The
        synthesis generator keeps its state."""
        self.synth_kwargs = dict(synth_kwargs or {})
        bank = self.synth_kwargs.pop("rir_bank", None)
        pool = self.synth_kwargs.pop("speech_pool", None)
        if not self.on_the_fly and (bank is not None or pool is not None):
            raise ValueError(
                "synth_kwargs rir_bank/speech_pool only apply to on_the_fly training; resident datasets draw from "
                "make_dataset(speech_pool=...) at build time"
            )
        self.rir_bank = None if bank is None else torch.as_tensor(bank).to(self.device)
        self.speech_pool = None
        if pool is not None:
            self.speech_pool = torch.as_tensor(pool, dtype=torch.float32).to(self.device)
            if self.speech_pool.shape[1] != self.task.config.audio_samples:
                raise ValueError(f"speech_pool length {self.speech_pool.shape[1]} != config.audio_samples "
                                 f"{self.task.config.audio_samples}")

    def otf_batch(self) -> SampleBatch:
        """One on-the-fly training batch of ``task.batch_size`` samples,
        synthesized on the device from the synthesis generator: with a
        speech pool, each sample's utterance is a pool row drawn first, then
        ``synthesize_batch`` draws the rest (the order ``make_dataset``
        draws a batch in), from the bank where one is set. Under data
        parallelism, this rank's block of the batch, from its own generator."""
        with span("train.otf_batch"):
            gen, b = self.synth_generator, self._block_size(self.task.batch_size)
            kw = dict(self.synth_kwargs)
            if self.rir_bank is not None:
                kw["rir_bank"] = self.rir_bank
            if self.speech_pool is not None:
                kw["speech"] = self.speech_pool[torch.randint(self.speech_pool.shape[0], (b,), generator=gen,
                                                              device=gen.device)]
            return synthesize_batch(gen, b, self.task.config, device=self.device, **kw)

    def to_device(self, data: SampleBatch) -> SampleBatch:
        return data.map(lambda a: torch.as_tensor(a).to(self.device))

    def _check_resident_fields(self, data: SampleBatch) -> None:
        """Refuse a dataset pruned of a field this task reads (an empty
        placeholder would fail later as a shape error in a conv)."""
        missing = [f for f in self.task.resident_fields
                   if getattr(data, f).dim() >= 2 and 0 in getattr(data, f).shape[1:]]
        if missing:
            raise ValueError(
                f"dataset was pruned without {missing}, which task {self.task.name!r} reads; "
                f"keep {tuple(self.task.resident_fields)}"
            )

    # ------------------------------------------------------- batch sampling

    def _block_size(self, n: int) -> int:
        """The size of this rank's block of ``n`` rows."""
        if self.dp is None:
            return n
        lo, hi = self.dp.block(n)
        return hi - lo

    def _stratified(self, n: int) -> bool:
        """Whether a set of ``n`` rows is sampled per rank from the rank's own
        block: the batch and the set divide by the world size (always in a
        world of one)."""
        take = min(self.task.batch_size, n)
        return take % self.world_size == 0 and n % self.world_size == 0

    def hold(self, data: SampleBatch) -> SampleBatch:
        """The rows of the resident set ``data`` this rank keeps: its block
        where the set is sampled stratified, else the whole set (with the JAX
        trainer's warning); ``data`` itself without data parallelism."""
        if self.dp is None:
            return data
        n = int(data.speech_spec.shape[0])
        if self._stratified(n):
            return shard_batch(data, self.dp)
        warnings.warn(  # the JAX trainer's warning, train/loop.py:400-411
            f"[{self.task.name}] batch {min(self.task.batch_size, n)} or dataset size {n} not divisible by the "
            f"data-parallel world size {self.world_size}: every rank holds the whole set and draws the global batch "
            "from a shared generator (slow). Pad the batch/dataset to a multiple of the world size for stratified "
            "sampling.", stacklevel=3)
        return data

    def _hold_on_device(self, data: SampleBatch) -> SampleBatch:
        """:meth:`hold` of a whole set, on the trainer's device, registered
        so that :meth:`sample` of it draws into the held rows."""
        n = int(data.speech_spec.shape[0])
        held = self.to_device(self.hold(data))
        self._held[id(held.speech_spec)] = n
        return held

    def _held_indices(self, n: int, device) -> torch.Tensor:
        """Indices of this rank's rows of a fresh batch from a set of ``n``
        rows, into the rows it holds (:meth:`hold`)."""
        take = min(self.task.batch_size, n)
        if self.dp is None:
            idx = sample_without_replacement(self.sample_generator, n, take)
        elif self._stratified(n):
            idx = sample_without_replacement(self.sample_generator, n // self.world_size, take // self.world_size)
        else:
            if take < self.world_size:
                raise ValueError(f"a batch of {take} rows leaves a rank of {self.world_size} without rows")
            lo, hi = self.dp.block(take)
            idx = sample_without_replacement(self.shared_sample_generator, n, take)[lo:hi]
        return idx.to(device)

    def _indices(self, data: SampleBatch) -> torch.Tensor:
        """Indices of this rank's rows of a fresh batch: into the rows it
        holds where ``data`` is a set :meth:`fit` holds, else into the whole
        set ``data``."""
        n = int(data.speech_spec.shape[0])
        held = self._held.get(id(data.speech_spec))
        if held is not None:
            return self._held_indices(held, data.speech_spec.device)
        idx = self._held_indices(n, data.speech_spec.device)
        if self.dp is not None and self._stratified(n):
            idx = idx + self.dp.block(n)[0]
        return idx

    @staticmethod
    def _rows(data: SampleBatch, idx: torch.Tensor) -> SampleBatch:
        return data.map(lambda a: a[idx].float() if a.dtype == torch.bfloat16 else a[idx])

    def sample(self, data: SampleBatch) -> SampleBatch:
        """A random batch of ``task.batch_size`` distinct rows (the whole set
        if it is smaller), bf16-stored arrays cast to float32; under data
        parallelism this rank's rows of it, ``data`` being the whole set."""
        with span("train.sample"):
            return self._rows(data, self._indices(data))

    def sample_cached(self, data: SampleBatch, cache: Cache) -> Tuple[SampleBatch, Cache]:
        """:meth:`sample` with the cache's rows of the same samples."""
        with span("train.sample"):
            idx = self._indices(data)
            return self._rows(data, idx), {k: v[idx] for k, v in cache.items()}

    def build_cache(self, data: SampleBatch) -> Cache:
        """The frozen-latent cache of a resident dataset: the task's code ids
        of every row (both branches' for the echoed stage, the RIR branch's
        for the location stage), in chunks of ``min(n, max(B, 8))`` rows with
        bf16-stored rows cast to float32 first, as a step sees them. Valid
        for the whole stage: the cached branches get no gradient, so Adam
        leaves their weights bitwise unchanged, and a resumed stage rebuilds
        the same cache from the same frozen weights."""
        if not self.task.supports_cache:
            raise ValueError(f"task {self.task.name!r} has no frozen path to cache")
        n = int(data.speech_spec.shape[0])
        chunk = min(n, max(int(self.task.batch_size), 8))
        parts = []
        with torch.no_grad(), full_fp32(), deterministic_convs():
            for i in range(0, n, chunk):
                idx = torch.arange(i, min(i + chunk, n), device=data.speech_spec.device)
                parts.append(self.task.step_cache(self.model, self.frozen_rir, self._rows(data, idx)))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def _loss(self, batch: SampleBatch, train: bool, cache: Optional[Cache]):
        return self.task.step_loss(self.model, self.frozen_rir, batch, train, self.jitter_generator, cache)

    def _step_context(self) -> contextlib.ExitStack:
        """Full FP32, the deterministic pin and, on a mesh, the quantizers'
        statistics over it and the time shards' mesh."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(full_fp32())
        ctx.enter_context(deterministic_convs())
        if self.dp is not None:
            ctx.enter_context(global_statistics(self.model, self.dp))
            if self.seq_axis is not None:
                ctx.enter_context(sequence_sharding(self.model, self.dp))
        return ctx

    def step(self, batch: SampleBatch, train: bool = True, cache: Optional[Cache] = None) -> Dict[str, torch.Tensor]:
        """One train step (loss, backward, Adam) or eval step on an already
        sampled batch, from its cache rows where given; returns the metrics
        as 0-d tensors, ``loss`` among them, without waiting for the device.
        Advances the step count.

        Under data parallelism ``batch`` is this rank's block of the global
        batch: the vector quantizers' statistics, the gradients (before Adam)
        and the metrics are reduced over the ranks, each rank weighted by its
        share of the global rows, so every rank returns the global batch's
        metrics and takes the same update. On time shards (a task's
        ``sequence_axis``) the step takes the rank's window of ``batch``'s time
        axis, and averages over the sequence axis too."""
        with span("train.step"):
            dp = self.dp
            if self._seq_sharded:
                batch = self._time_window(batch)
            with self._step_context():
                if train and dp is not None:
                    metrics = self._dp_step((batch, cache), rows=int(batch.speech_spec.shape[0]))
                elif train:
                    self.optimizer.zero_grad(set_to_none=True)
                    loss, metrics = self._loss(batch, True, cache)
                    with span("train.backward"):
                        loss.backward()
                    self.optimizer.step()
                    metrics = {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}
                else:
                    with torch.no_grad():
                        loss, metrics = self._loss(batch, False, cache)
                    metrics = {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}
                    if dp is not None:
                        weight = step_weight(int(batch.speech_spec.shape[0]), dp, self.device)
                        metrics = reduce_metrics(metrics, dp, weight, [k for k in metrics if k.endswith("perplexity")])
            self.step_count += 1
            return metrics

    # ------------------------------------------------------------------- fit

    def request_preemption(self) -> None:
        """Ask the running fit() to checkpoint and raise :class:`Preempted`
        before its next step. Signal-handler-safe (sets a flag only); also
        the path for callers outside the main thread, where fit() cannot
        install its SIGTERM handler."""
        self._preempt_requested = True

    def fit(
        self,
        train_data: SampleBatch,
        val_data: Optional[SampleBatch] = None,
        num_updates: Optional[int] = None,
        resume: bool = False,
        save_final: bool = True,
    ) -> TrainHistory:
        """Run the stage from the trainer's step count up to ``num_updates`` (the
        task's count when 0 or None) over the resident ``train_data``, over
        the chunks of a :class:`..data.HostStagedDataset` (see the module
        docstring), or, ``on_the_fly``, over synthesized batches
        (``train_data`` is unused and may be None, ``val_data`` is
        required); with ``val_data`` and
        ``val_replaces_train`` every ``eval_every``-th step is an eval step
        on it instead. With ``cache_frozen`` and a task that supports it, the
        cache of each resident dataset is built first.

        With ``resume=True`` and a store, the stage restarts from its newest
        periodic checkpoint (weights, Adam, step and generators), so a crash
        loses at most ``ckpt_every`` updates. ``save_final=False`` leaves out
        the stage-final checkpoint (periodic ones still save).

        While running, SIGTERM triggers graceful preemption: the loop saves a
        resumable checkpoint at the next step boundary and raises
        :class:`Preempted`; nothing is saved before the first step. Under
        data parallelism ``train_data`` and ``val_data`` are the whole sets
        (each rank keeps its rows, :meth:`hold`), and a signal on any rank
        stops them all at the same boundary."""
        installed = False
        try:
            prev = signal.signal(signal.SIGTERM, lambda *_: self.request_preemption())
            installed = True
        except ValueError:
            prev = None  # not the main thread: flag-only preemption
        try:
            return self._fit(train_data, val_data, num_updates, resume, save_final)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
            self._preempt_requested = False
            self._held.clear()
            self.resident_chunk = None

    def _fit(self, train_data, val_data, num_updates, resume, save_final) -> TrainHistory:
        num_updates = num_updates or self.task.num_updates
        host = train_data if isinstance(train_data, HostStagedDataset) else None
        if host is not None and self.on_the_fly:
            raise ValueError("host-staged train data is pointless with on_the_fly")
        if train_data is None and not self.on_the_fly:
            raise ValueError("train_data=None requires on_the_fly=True")
        if self.on_the_fly and val_data is None:
            raise ValueError("on-the-fly training still needs val_data (or a small stub)")
        if resume:
            restored = self.restore_latest()
            if restored is not None and self.verbose:
                print(f"[{self.task.name}] resumed at step {restored}", flush=True)
        caching = self.cache_frozen and self.task.supports_cache
        frozen_before = self._frozen_fingerprint() if caching and not self._default_optimizer else None
        train_cache = None
        stager = None
        if self.on_the_fly:
            train_data = None
        elif host is not None:
            stager = _ChunkStager(self, host)
            train_data = stager.hold(self.step_count)
            self._check_resident_fields(train_data)
            train_cache = self.build_cache(train_data) if caching else None
            if self.verbose:
                print(f"[{self.task.name}] host-staged dataset: {host.size} rows, {host.num_chunks} chunks of "
                      f"{host.chunk_size} resident, rotating every {host.rotate_every} steps", flush=True)
        else:
            train_data = self._hold_on_device(train_data)
            self._check_resident_fields(train_data)
            train_cache = self.build_cache(train_data) if caching else None
        val_cache = None
        if val_data is not None:
            val_data = self._hold_on_device(val_data)
            if caching and self.val_replaces_train:
                val_cache = self.build_cache(val_data)
        if self.verbose and caching:
            print(f"[{self.task.name}] frozen-latent cache built", flush=True)
        history = TrainHistory()
        t0 = time.perf_counter()
        frames = 0
        start = self.step_count
        trace_window = (start + 2, min(start + 7, num_updates))  # steady-state steps
        with contextlib.ExitStack() as tracing:
            for i in range(start, num_updates):
                if self.dp.any(self._preempt_requested) if self.dp else self._preempt_requested:
                    tracing.close()
                    if self.store is not None and i > start:
                        # the periodic tag convention, so restore_latest finds it
                        self.save_checkpoint(tag=f"{self.task.name}_{i}")
                    raise Preempted(self.task.name, i)
                if stager is not None:
                    rotated = stager.before_step(i)
                    if rotated is not None:
                        train_data = rotated
                        train_cache = self.build_cache(train_data) if caching else None
                if self.profile_dir and i == trace_window[0]:
                    tracing.enter_context(trace(self.profile_dir, self.task.name))
                is_val = (
                    val_data is not None and self.val_replaces_train and (i + 1) % self.task.eval_every == 0
                )
                data, cache = (val_data, val_cache) if is_val else (train_data, train_cache)
                if self.on_the_fly and not is_val:
                    batch, rows = self.otf_batch(), None
                elif cache is None:
                    batch, rows = self.sample(data), None
                else:
                    batch, rows = self.sample_cached(data, cache)
                metrics = self.step(batch, train=not is_val, cache=rows)
                if not is_val:
                    # loop.py:710: frames of the nominal batch
                    frames += self.task.batch_size * self.task.config.num_frames
                history.append(metrics, val=is_val)
                if self.profile_dir and trace_window[0] <= i == trace_window[1] - 1:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    tracing.close()
                    if self.verbose:
                        print(f"[{self.task.name}] trace written to {self.profile_dir}", flush=True)
                if self.verbose and (i + 1) % self.log_every == 0:
                    parts = [f"[{self.task.name}] {i + 1} iterations"]
                    parts += [f"{k}: {history.running_mean(k):.4f}" for k in metrics]
                    if frames:
                        parts.append(f"({frames / (time.perf_counter() - t0):.0f} frames/s)")
                    print("  ".join(parts), flush=True)
                if self.store is not None and (i + 1) % self.task.ckpt_every == 0:
                    self.save_checkpoint(tag=f"{self.task.name}_{i + 1}")
        if frozen_before is not None:
            self._check_frozen_constant(frozen_before)
        if self.store is not None and save_final:
            self.save_checkpoint(tag=self.task.name, final=True)
        return history

    def _frozen_fingerprint(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """CPU copies of the weights the frozen-latent cache assumes constant
        (the task's ``cached_frozen_subtrees``, e.g. the echoed stage's
        branches). Needed only with a supplied optimizer: the cache is valid
        where a parameter without a gradient gets no update, which Adam
        guarantees and an optimizer that decays every parameter it holds
        does not."""
        out = {}
        for name in getattr(self.task, "cached_frozen_subtrees", ()):
            module = getattr(self.model, name, None)
            if module is not None:
                out[name] = {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}
        return out

    def _check_frozen_constant(self, before: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Raise JAX's error where a cached branch's weights changed bitwise."""
        after = self._frozen_fingerprint()
        as_bytes = lambda t: t.reshape(-1).view(torch.uint8)
        for name, tensors in before.items():
            for k, b in tensors.items():
                if not torch.equal(as_bytes(after[name][k]), as_bytes(b)):
                    raise RuntimeError(
                        f"cache_frozen=True but frozen subtree {name!r} changed during training: the supplied "
                        "optimizer does not map zero grads to zero updates (e.g. weight decay), so the "
                        "frozen-latent cache is stale. Use torch.optim.Adam or leave the frozen subtrees out of "
                        "the optimizer."
                    )

    # ----------------------------------------------------------- checkpoints

    def _gather_states(self, gen: torch.Generator) -> torch.Tensor:
        """Every rank's state of its ``gen``, ``(world_size, n)`` uint8 on
        the CPU (row r: rank r's)."""
        state = gen.get_state().to(self.device, torch.int32)
        return self.dp.gather_rows(state).to("cpu", torch.uint8)

    def save_checkpoint(self, tag: str, final: bool = False) -> None:
        """Save the trainer's state under ``tag``, with the task's
        evaluation-relevant configuration as metadata; then retire all but
        the newest ``keep_checkpoints`` periodic checkpoints of the task.
        Under data parallelism every rank calls it (the generators' states
        and the blocks of split parameters are gathered) and the mesh's first
        rank alone writes; the call returns once the checkpoint is in the
        store."""
        tree = {
            # whole tensors, whatever the model axis splits: a store resumes under another split
            "model": full_state_dict(self.model),
            "optimizer": full_optimizer_state(self.model, self.optimizer),
            "step": self.step_count,
            "sample_generator": self.sample_generator.get_state(),
            "jitter_generator": self.jitter_generator.get_state(),
        }
        if self.on_the_fly:
            tree["synth_generator"] = self.synth_generator.get_state()
        if self.dp is not None:
            ranks = {"world_size": self.world_size, "sample_generators": self._gather_states(self.sample_generator),
                     "shared_sample_generator": self.shared_sample_generator.get_state()}
            if self.on_the_fly:
                ranks["synth_generators"] = self._gather_states(self.synth_generator)
            tree["data_parallel"] = ranks
        if self.dp is None or self.dp.lead:
            self.store.save_stage(tag, tree, step=self.step_count, metadata=checkpoint_metadata(self.task, final))
            if not final and self.keep_checkpoints > 0:
                prefix = f"{self.task.name}_"
                periodic = sorted(
                    ((t, m) for t, m in self.store.stages().items()
                     if t.startswith(prefix) and t[len(prefix):].isdigit()),
                    key=lambda x: _ckpt_rank(x[1]),
                )
                for t, _ in periodic[: -self.keep_checkpoints]:
                    self.store.delete_stage(t)
        if self.dp is not None:
            self.dp.barrier()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with whole tensors (split parameters
        gathered over the model axis; every rank of it must call this)."""
        return full_state_dict(self.model)

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load a whole-tensor state dict into the model (each split
        parameter takes its rank's block)."""
        self.model.load_state_dict(shard_state_dict(self.model, state))

    def load_stage_params(self, name: str) -> Dict[str, torch.Tensor]:
        """The model state dict of stage ``name`` in the store (on the CPU)."""
        return self.store.load_stage(name)["model"]

    def restore_latest(self) -> Optional[int]:
        """Load the newest periodic checkpoint of this task from the store
        into the trainer (weights, Adam, step, generators) and return the
        completed updates, or None when there is none. "Newest" is by
        :func:`_ckpt_rank`, the ranking the GC retires by, so resume never
        picks a tag the GC is about to delete, nor a previous run's stale
        higher-step tag."""
        if self.store is None:
            return None
        prefix = f"{self.task.name}_"
        best = None
        for tag, meta in self.store.stages().items():
            if tag.startswith(prefix) and tag[len(prefix):].isdigit():
                rank = _ckpt_rank(meta)
                if best is None or rank > best[1]:
                    best = (tag, rank)
        if best is None:
            return None
        tree = self.store.load_stage(best[0])  # on the CPU, where the generators' states live
        if self.on_the_fly and "synth_generator" not in tree:
            raise ValueError(f"checkpoint {best[0]!r} holds no synthesis generator: it was not saved by an "
                             "on-the-fly run, so this one cannot continue its batches")
        ranks = tree.get("data_parallel")
        saved_world = ranks["world_size"] if ranks else 1
        if saved_world != self.world_size:
            raise ValueError(f"checkpoint {best[0]!r} was written by {saved_world} data-parallel ranks; resume it "
                             f"with the same world size, not {self.world_size} (each rank's batches continue from "
                             "its own generators)")
        self.model.load_state_dict(shard_state_dict(self.model, tree["model"]))
        self.optimizer.load_state_dict(shard_optimizer_state(self.model, self.optimizer, tree["optimizer"]))
        self.jitter_generator.set_state(tree["jitter_generator"])
        if self.dp is not None and ranks:
            # a row of its own storage: set_state reads a state from the start of the storage
            self.sample_generator.set_state(ranks["sample_generators"][self.dp.rank].clone())
            self.shared_sample_generator.set_state(ranks["shared_sample_generator"])
            if self.on_the_fly:
                self.synth_generator.set_state(ranks["synth_generators"][self.dp.rank].clone())
        else:
            self.sample_generator.set_state(tree["sample_generator"])
            if self.on_the_fly:
                self.synth_generator.set_state(tree["synth_generator"])
        self.step_count = int(tree["step"])
        return self.step_count


def _ckpt_rank(meta: dict):
    """Recency ranking for periodic checkpoints, the one key both the GC
    (retire lowest-ranked) and restore_latest (resume highest-ranked) use.
    Primary: the store's monotonic per-save ``seq`` counter, which survives
    wall-clock steps and a retrain into a store still holding a previous
    run's higher-step tags; then save time, then step."""
    return (meta.get("seq", -1), meta.get("time", meta["step"]))


class _ChunkStager:
    """The chunk of a host-staged set that :meth:`Trainer.fit` holds on the
    device: chunk ``step // rotate_every`` (cyclic) at every step, the next
    one copied on a side stream from the window's prefetch offset (see the
    module docstring). On the CPU the chunks are views of the host set."""

    def __init__(self, trainer: Trainer, host: HostStagedDataset):
        self.trainer, self.host = trainer, host
        self.every = int(host.rotate_every)
        self.prefetch_at = max(1, (self.every + 1) // 2)  # JAX loop.py:658
        self.on_card = trainer.device.type == "cuda"
        if self.on_card and not all(a.is_pinned() for a in host.arrays if a.numel()):
            # from pageable memory a non_blocking copy is staged and synchronous: the prefetch would not overlap
            raise ValueError("a host-staged set on a CUDA trainer must be in pinned memory: build it with "
                             "make_host_dataset, or HostStagedDataset(..., pin_memory=True)")
        self.stream = torch.cuda.Stream(trainer.device) if self.on_card else None
        self.held: Optional[SampleBatch] = None
        self.next = None  # (chunk index, the chunk on the device, the copy's event)

    def _copy(self, c: int, side: bool):
        """Chunk ``c``'s rows this rank holds, on the trainer's device: on the
        side stream with an event where ``side``, else in stream order."""
        rows = self.trainer.hold(self.host.chunk(c))
        if not (side and self.on_card):
            return self.trainer.to_device(rows), None
        with torch.cuda.stream(self.stream):
            chunk = rows.map(lambda a: a.to(self.trainer.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        return chunk, event

    def hold(self, step: int) -> SampleBatch:
        """Hold the chunk of ``step``: the prefetched one once the compute
        stream has waited on its copy, else one copied now; registered with
        the trainer's sampler, the previous one released."""
        c = step // self.every
        if self.next is not None and self.next[0] % self.host.num_chunks == c % self.host.num_chunks:
            _, chunk, event = self.next
            if event is not None:
                compute = torch.cuda.current_stream(self.trainer.device)
                compute.wait_event(event)
                for a in chunk:
                    a.record_stream(compute)  # its memory waits for the steps queued on it
        else:
            chunk, _ = self._copy(c, side=False)
        self.next = None
        held = self.trainer._held
        if self.held is not None:
            held.pop(id(self.held.speech_spec), None)
        held[id(chunk.speech_spec)] = self.host.chunk_size
        self.held = chunk
        self.trainer.resident_chunk = c % self.host.num_chunks
        return chunk

    def before_step(self, step: int) -> Optional[SampleBatch]:
        """Before ``step``: the new chunk where the step opens a window with
        another chunk, else None (after starting the next chunk's copy from
        the window's prefetch offset)."""
        n, c = self.host.num_chunks, step // self.every
        if c % n != self.trainer.resident_chunk:
            return self.hold(step)
        if step % self.every >= self.prefetch_at and self.next is None and (c + 1) % n != c % n:
            self.next = (c + 1, *self._copy(c + 1, side=True))
        return None
