"""Loop ``serve``: one caller in a closed loop over the program's serving
closure (``eval/serving.py:make_serving_fn``), each call a batch of
``batch`` spectrograms taken in turn from ``pool_batches`` distinct seeded
batches resident on the card (``harness/inputs.py``), each call timed from
a synchronised device until its outputs are synchronised and fetched to the
host (``cli/common.py:latency_bench``'s discipline, copied).

Mix keys besides: ``latent_rows`` (the codebook's batch), ``warmup_steps``
(the calls of the warm-up), ``compare_within`` (each input batch's compared
call is one of its first ``compare_within`` calls, drawn from the seed),
``trace_steps``. The compared calls' answers and the codes they assigned
are kept as the window runs. Fault: ``altered_answer`` (the first row's
angle moved by 0.5 rad where it is produced).
"""

from __future__ import annotations

import torch

from harness import check, inputs
from harness.cell import sub_seed
from harness.training import CodeTap
from harness.window import Loop, timed_calls, warm_up


# the program's modules this loop calls: imported in the set-up's import phase
PROGRAM = ("acoustic_locating_vq_vae_torch.eval.serving",)


def fetch(out) -> float:
    """The outputs' sum on the host: one read that waits for every output."""
    return float(sum(torch.sum(t) for t in out))


class Serving(Loop):
    def __init__(self, ctx):
        super().__init__(ctx)
        from acoustic_locating_vq_vae_torch.eval.serving import make_serving_fn

        t = ctx.traffic
        self.serve = make_serving_fn(ctx.port_task, ctx.params, ctx.geo, device=ctx.device)
        self.call = self.serve
        if ctx.fault == "altered_answer":
            def altered(x):
                th, r, c = self.serve(x)
                return th + torch.where(torch.arange(th.shape[0], device=th.device) == 0, 0.5, 0.0), r, c

            self.call = altered
        ctx.mark("serving closure")
        self.n_in = n_in = t["pool_batches"]
        made = inputs.spectrograms(ctx.gen, n_in * ctx.batch, ctx.geometry)
        self.inputs = made.reshape(n_in, ctx.batch, *made.shape[1:])
        del made
        picks = torch.randint(t["compare_within"], (n_in,),
                              generator=torch.Generator().manual_seed(sub_seed(ctx.seed, 5))).tolist()
        self.due = {j + n_in * k: j for j, k in enumerate(picks)}  # call index -> input batch compared
        self.answers, self.codes, self.calls = {}, {}, 0
        ctx.mark("input pool")
        warm_up(lambda: fetch(self.call(self.inputs[0])), ctx.sync, t["warmup_steps"])
        ctx.mark("warm-up")
        self.counts = ctx.config.counts(ctx.cfg, "serve", ctx.batch)

    def step(self):
        i = self.calls
        j = self.due.get(i)
        if j is None:
            out = self.call(self.inputs[i % self.n_in])
        else:  # a compared call: its codes read by hooks that exist for this call alone
            tap = CodeTap(self.serve.modules[0], self.ctx.config.QUANTIZERS)
            tap.on = True
            out = self.call(self.inputs[i % self.n_in])
            tap.remove()
            self.answers[j] = tuple(t.clone() for t in out)
            self.codes[j] = tap.take()
        self.calls = i + 1
        return out

    def unit(self) -> None:
        out = self.step()
        self.ctx.sync()
        fetch(out)

    def window(self, seconds: float):
        self.calls = 0
        return timed_calls(self.step, seconds, self.ctx.sync, fetch)

    def after_window(self) -> None:
        """The compared calls not yet served (no window, or a short one)."""
        while len(self.answers) < self.n_in:
            self.step()
        self.ctx.sync()

    def release(self) -> None:
        del self.serve, self.call

    def check(self, control: bool):
        ctx = self.ctx
        order = sorted(self.answers)
        xs = self.inputs[order]
        branch = next(iter(ctx.config.QUANTIZERS))
        got, codes = [self.answers[j] for j in order], [self.codes[j].get(branch) for j in order]
        tie = ctx.limits["tie_margin"]
        ref = lambda c, dtype, on: check.serve_reference(ctx.config, ctx.cfg, ctx.geometry, ctx.params, xs, c, dtype,
                                                          on, ctx.device)
        numbers = check.serve_numbers(got, codes, ref(codes, torch.float64, False), tie)
        if not control:
            return numbers, None
        c = ref(None, torch.float32, True)
        c_answers, c_codes = [w[0] for w in c], [w[1] for w in c]
        return numbers, check.serve_numbers(c_answers, c_codes, ref(c_codes, torch.float64, False), tie)


def setup(ctx):
    return Serving(ctx)
