"""Loop ``train``: a closed loop of the program's training step.

The mix's ``source`` says where each step's batch comes from:

* ``resident``: ``Trainer.step(Trainer.sample(set))`` over a resident set of
  ``rows`` seeded spectrograms made on the card (``harness/inputs.py``; the
  mix's ``fields`` are held), or, with the mix's ``cache_frozen``,
  ``Trainer.step(*Trainer.sample_cached(set, cache))`` with the
  frozen-latent cache built at set-up by ``Trainer.build_cache`` (which the
  traffic needs);
* ``on_the_fly``: ``Trainer.step(Trainer.otf_batch())``, each batch
  synthesized on the card by the program from its synthesis generator,
  seeded from the run's seed, with ``synth_kwargs`` (none: the reference
  generator's fixed geometry and the synthetic speech). The traced window
  records the benchmark's own span around ``otf_batch``.

Mix keys besides: ``latent_rows`` (the codebooks' batch), ``warmup_steps``
(the steps of the warm-up), ``trace_steps``. Faults (tests and ``control.py``):
``frozen_state``, ``half_batch``, ``late_half_batch`` (half of each batch
left out from the warm-up on: only the step after the window sees it), and
on the fly ``altered_sample`` (one sample of each synthesized batch scaled
by 1.1 where it is produced).
"""

from __future__ import annotations

import torch

from harness import check, inputs
from harness.cell import sub_seed
from harness.training import TrainingLoop

# the span around the synthesis of a batch in a traced window (metrics/synth_share.otf.py reads it)
SPAN = "bench.otf_batch"
# the program's modules this loop calls: imported in the set-up's import phase
PROGRAM = ("acoustic_locating_vq_vae_torch.train.loop", "acoustic_locating_vq_vae_torch.data.synth")


class Train(TrainingLoop):
    def __init__(self, ctx):
        super().__init__(ctx)
        from acoustic_locating_vq_vae_torch.data.synth import SampleBatch

        t = ctx.traffic
        self.otf = t["source"] == "on_the_fly"
        self.cache = self.data = None
        self.tracing = False
        if self.otf:
            trainer = self.make_trainer(on_the_fly=True, synth_kwargs=t.get("synth_kwargs", {}))
            trainer.synth_generator = torch.Generator(ctx.device).manual_seed(sub_seed(ctx.seed, 4))
            self.start("train")
            return
        cached = bool(t.get("cache_frozen"))
        trainer = self.make_trainer(cache_frozen=cached)
        self.data = SampleBatch(**inputs.resident(ctx.gen, t["rows"], ctx.geometry, t["fields"]))
        ctx.mark("resident set")
        if cached:
            self.cache = trainer.build_cache(self.data)
            ctx.sync()
            ctx.mark("cache")
        self.start("train_cached" if cached else "train")

    def traced(self, on: bool) -> None:
        self.tracing = on

    def _otf_batch(self):
        if not self.tracing:
            return self.trainer.otf_batch()
        from torch.profiler import record_function

        with record_function(SPAN):
            return self.trainer.otf_batch()

    def one_step(self):
        rows = None
        if self.otf:
            b = self._otf_batch()
            if self.ctx.fault == "altered_sample":
                scale = torch.where(torch.arange(b.echoed_spec.shape[0], device=b.echoed_spec.device) == 0, 1.1, 1.0)
                b = b._replace(echoed_spec=b.echoed_spec * scale[:, None, None])
            if self.recording:
                self.rec.batches.append({"echoed_spec": b.echoed_spec.detach().clone(), "theta": b.theta.clone(),
                                         "radius": b.radius.clone()})
        elif self.cache is None:
            b = self.trainer.sample(self.data)
        else:
            b, rows = self.trainer.sample_cached(self.data, self.cache)
        if self.halve is not None:
            b = b.map(self.halve)
            rows = None if rows is None else {k: self.halve(v) for k, v in rows.items()}
        return self.trainer.step(b, cache=rows), b

    def release(self) -> None:
        """Keep the echoed rows (the benchmark's input) and the cache's codes
        (what is judged); free the rest."""
        super().release()
        if self.data is not None:
            self.saved, self.saved_cache = self.data.echoed_spec, self.cache
        self.data = self.cache = None

    def check(self, control: bool):
        ctx = self.ctx
        jit = self.jitters()
        if self.otf:
            return self._check_otf(jit, control)
        data = self.saved
        n = data.shape[0]
        # the rows of the first three steps, drawn as the trainer draws them from the same seed, and of the
        # step after the window, from the snapshot's generator
        g = torch.Generator().manual_seed(sub_seed(ctx.seed, 2))
        idx = [torch.randperm(n, generator=g)[: ctx.cfg["train_batch"]] for _ in range(3)]
        g.set_state(self.post["snap"]["sample"])
        idx = [i.to(ctx.device) for i in idx + [torch.randperm(n, generator=g)[: ctx.cfg["train_batch"]]]]
        if self.saved_cache is not None:  # the steps' codes are the cache's rows that they read
            codes = [{name: self.saved_cache[name + "_codes"][i] for name in ctx.config.QUANTIZERS} for i in idx]
            self.rec.codes, self.post["rec"].codes = codes[:3], codes[3:]
        batches = [{"echoed_spec": data[i]} for i in idx]
        return self.check_steps(batches[:3], batches[3], jit, control)

    def _check_otf(self, jit, control: bool):
        """The synthesis of the first three steps and of the step after the
        window against the reference's of the same draws (worked out again
        from the synthesis generator's seed and from its snapshot), and the
        steps from the program's synthesized batches (a float32 batch lies
        some 1e-5 of its largest value from float64's, enough to flip a
        near-tie code)."""
        from reference.draws import fixed_geometry_draws

        ctx, rec = self.ctx, self.rec
        gen = torch.Generator(ctx.device).manual_seed(sub_seed(ctx.seed, 4))
        draws = [fixed_geometry_draws(gen, ctx.cfg["train_batch"], ctx.geometry) for _ in range(3)]
        gen.set_state(self.post["snap"]["synth"])
        draws.append(fixed_geometry_draws(gen, ctx.cfg["train_batch"], ctx.geometry))
        c_batches = check.control_batches(draws, ctx.geometry, ctx.device) if control else None
        got = rec.batches + self.post["rec"].batches
        numbers, ctrl = self.check_steps(got[:3], got[3], jit, control, c_batches)
        tol = ctx.limits["synth_tol"]
        numbers.update(check.synth_numbers(got, draws, ctx.geometry, tol))
        if control:
            ctrl.update(check.synth_numbers(c_batches, draws, ctx.geometry, tol))
        return numbers, ctrl


def setup(ctx):
    return Train(ctx)
