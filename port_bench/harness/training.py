"""What the training loops share: the program's ``Trainer`` on the
benchmark's weights, the taps that keep the codes its quantizers assign,
the first three steps and the step after the window that the check reads,
the warm-up, and their check."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import check
from .cell import check_shapes, sub_seed
from .window import Loop, warm_up


class CodeTap:
    """Forward hooks on the program's quantizers (``{branch: module path}``)
    that keep the code ids each assigns, as (B, R), while ``on``: a
    quantizer's input is (B, ..., D), whichever flatten it uses."""

    def __init__(self, model: torch.nn.Module, quantizers: Dict[str, str]):
        self.on, self.got = False, {}
        self.handles = [model.get_submodule(path).register_forward_hook(self._hook(name))
                        for name, path in quantizers.items()]

    def _hook(self, name):
        def hook(module, args, output):
            if self.on:
                self.got[name] = output.indices.detach().reshape(args[0].shape[0], -1).clone()
        return hook

    def take(self) -> Dict[str, torch.Tensor]:
        got, self.got = self.got, {}
        return got

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class TrainingLoop(Loop):
    """A closed loop of the program's training step. A subclass sets
    ``one_step()`` -> (the step's metrics, the batch it trained on) and
    calls :meth:`start` at the end of its set-up."""

    def make_trainer(self, **kw):
        from acoustic_locating_vq_vae_torch.train.loop import Trainer

        ctx = self.ctx
        trainer = Trainer(ctx.port_task, device=ctx.device, seed=0, verbose=False, **kw)
        check_shapes(trainer.model, ctx.params)
        trainer.model.load_state_dict(ctx.params)
        trainer.sample_generator = torch.Generator().manual_seed(sub_seed(ctx.seed, 2))
        trainer.jitter_generator = torch.Generator().manual_seed(sub_seed(ctx.seed, 3))
        if ctx.fault == "frozen_state":
            trainer.optimizer.step = lambda *a, **k: None
        self.trainer = trainer
        self.halve = self.halver if ctx.fault == "half_batch" else None
        self.rec, self.post = check.TrainRecord(), None
        self.recording = False
        ctx.mark("trainer")
        return trainer

    @staticmethod
    def halver(a: torch.Tensor) -> torch.Tensor:
        return a[: a.shape[0] // 2]

    def one_step(self):
        raise NotImplementedError

    def step(self) -> None:
        self.one_step()

    def start(self, kind: str) -> None:
        """The first three steps, through the window's own call: what the
        check reads (losses, Adam's first moments, the change, the codes).
        Then the warm-up, a fixed count of steps. ``kind``: the
        configuration's FLOP count of a step."""
        ctx = self.ctx
        for i in range(3):
            metrics, codes = self.recorded_step()
            self.rec.codes.append(codes)
            check.record_step(self.rec, i, self.trainer, ctx.params, metrics)
        ctx.sync()
        ctx.mark("first steps")
        if ctx.fault == "late_half_batch":  # a path that differs only once the first steps are done
            self.halve = self.halver
        warm_up(self.step, ctx.sync, ctx.traffic["warmup_steps"])
        ctx.mark("warm-up")
        self.counts = ctx.config.counts(ctx.cfg, kind, ctx.batch)

    def recorded_step(self):
        """One step through the window's call, with the codes its quantizers
        assign and (on the fly) its batch kept: (the step's metrics, the
        codes by branch)."""
        tap = CodeTap(self.trainer.model, self.ctx.config.QUANTIZERS)
        self.recording = tap.on = True
        try:
            metrics, _ = self.one_step()
        finally:
            self.recording = tap.on = False
            tap.remove()
        return metrics, tap.take()

    def after_window(self) -> None:
        """One more recorded step of the object the window drove, from a
        snapshot of its parameters, Adam's state and its generators taken just
        before it: what the check reads of the state the window left."""
        tr = self.trainer
        named = dict(tr.model.named_parameters())
        with torch.no_grad():
            snap = {"params": {k: p.detach().clone() for k, p in named.items()}, "m": {}, "v": {}, "t": 0,
                    "sample": tr.sample_generator.get_state(), "jitter": tr.jitter_generator.get_state(),
                    "synth": tr.synth_generator.get_state() if self.ctx.traffic["source"] == "on_the_fly" else None}
            for k, p in named.items():
                st = tr.optimizer.state.get(p)
                if st and "exp_avg" in st:
                    snap["m"][k], snap["v"][k] = st["exp_avg"].clone(), st["exp_avg_sq"].clone()
                    snap["t"] = int(st["step"])
        metrics, codes = self.recorded_step()
        post = check.TrainRecord()
        post.losses.append(float(metrics["loss"]))
        post.change_norms = check.change_norms(tr.model, snap["params"])
        post.codes.append(codes)
        if self.rec.batches[3:]:
            post.batches.append(self.rec.batches.pop())
        self.post = {"rec": post, "snap": snap, "since_start": check.change_norms(tr.model, self.ctx.params)}
        self.ctx.sync()

    def release(self) -> None:
        del self.trainer

    def check_steps(self, batches: List[Dict[str, torch.Tensor]], post_batch: Dict[str, torch.Tensor], jitters,
                    control: bool, control_batches: Optional[List[Dict[str, torch.Tensor]]] = None):
        """The first three steps, and the step after the window from its
        snapshot, against the reference's (float64) on ``batches`` and
        ``post_batch``; the control's, the reference in float32 with TF32 on,
        on ``control_batches`` (default the same; the last one the step
        after the window's)."""
        ctx = self.ctx
        lr, f64, tie = ctx.cfg["learning_rate"], torch.float64, ctx.limits["tie_margin"]
        steps = ctx.config.CODE_STEPS
        snap, post = self.post["snap"], self.post["rec"]

        def train(b, dtype, on, follow):
            first = check.reference_train(ctx.config, ctx.cfg, ctx.params, b[:3], jitters[:3], lr, dtype, on,
                                          ctx.device, follow and follow[:3], tie)
            after = check.reference_train(ctx.config, ctx.cfg, snap["params"], b[3:], jitters[3:], lr, dtype, on,
                                          ctx.device, follow and follow[3:], tie, adam=snap)
            return first, after

        def numbers(got, got_post, want, want_post, since_start):
            n = check.train_numbers(got, want)
            n.update(check.post_numbers(got_post, want_post))
            n["frozen_change"] = max(n["frozen_change"], check.untrained_change(since_start, want))
            n.update(check.codes_numbers(got.codes[:steps] + got_post.codes, want.codes[:steps] + want_post.codes,
                                         want.margins[:steps] + want_post.margins, steps + 1, tie))
            return n

        want, want_post = train(batches + [post_batch], f64, False, self.rec.codes + post.codes)
        out = numbers(self.rec, post, want, want_post, self.post["since_start"])
        if not control:
            return out, None
        # the control in the program's place: its codes are the ones the float64 reference follows at ties
        c_batches = control_batches or batches + [post_batch]
        got, got_post = train(c_batches, torch.float32, True, None)
        want, want_post = train(c_batches, f64, False, got.codes + got_post.codes)
        return out, numbers(got, got_post, want, want_post, {})

    def jitters(self) -> list:
        """The decoder's batch-shared jitter decisions of the first three
        steps and of the step after the window, drawn as the trainer draws
        them from the same seed and from the snapshot's generator."""
        ctx = self.ctx
        length, p = ctx.frames, ctx.cfg["decoder"]["jitter_probability"]
        pair = lambda g: (torch.rand((length,), generator=g) < p, torch.rand((length,), generator=g) < 0.5)
        gj = torch.Generator().manual_seed(sub_seed(ctx.seed, 3))
        first = [pair(gj) for _ in range(3)]
        gj.set_state(self.post["snap"]["jitter"])
        return first + [pair(gj)]
