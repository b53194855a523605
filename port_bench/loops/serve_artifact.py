"""Loop ``serve_artifact``: the ``serve`` loop over the exported localizer.
At set-up, after the ``serve`` loop's own (the live closure, the input pool,
the compared calls; the live closure's warm-up left out, since it serves no
request and only the export reads it), ``eval/serving.py:export_localizer``
writes that closure to a ``localizer.pt2`` in a temporary directory and
``load_localizer`` loads it cold, as a deployment loads it; the window then
calls the loaded artifact, warmed up with the traffic's ``warmup_steps``.

A loaded artifact has no modules to hook, so the codes of a compared call
are read from the graph's calls of the assignment operator
(``acoustic_locating_vq_vae_torch::vq_nearest``) by a dispatch mode that
exists for that call alone; the check is the ``serve`` loop's.

Faults: ``frozen_state`` (every call returns the warm-up's first outputs),
``half_batch`` (the second half of each call's rows given the first half's
outputs).
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from harness.cell import load_benchmark, load_part
from harness.window import warm_up

_serve = load_part(load_benchmark(Path(__file__).resolve().parents[2]), "loops", "serve")
PROGRAM = _serve.PROGRAM
fetch = _serve.fetch
# the assignment operator an exported localizer's graph calls
OP = "acoustic_locating_vq_vae_torch::vq_nearest"


class _Codes(TorchDispatchMode):
    """Keeps the ids of every call of the assignment operator while open."""

    def __init__(self):
        super().__init__()
        self.ids = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.name().split(".")[0] == OP:
            self.ids.append(out.clone())
        return out


class ArtifactServing(_serve.Serving):
    def __init__(self, ctx):
        traffic = ctx.traffic
        ctx.traffic = {**traffic, "warmup_steps": 0}  # the live closure's warm-up: no call of it is timed
        try:
            super().__init__(ctx)
        finally:
            ctx.traffic = traffic
        from acoustic_locating_vq_vae_torch.eval.serving import export_localizer, load_localizer

        with tempfile.TemporaryDirectory() as out:
            export_localizer(ctx.port_task, ctx.params, ctx.geo, out, device=ctx.device, serve_fn=self.serve)
            ctx.mark("export")
            artifact, _ = load_localizer(out, device=ctx.device)
        ctx.mark("artifact load")
        self.call = artifact
        if ctx.fault == "frozen_state":
            first = tuple(o.clone() for o in artifact(self.inputs[0]))
            self.call = lambda x: first
        elif ctx.fault == "half_batch":
            def half(x):
                h = x.shape[0] // 2
                return tuple(torch.cat([o[:h], o[:h]])[: x.shape[0]] for o in artifact(x))

            self.call = half
        warm_up(lambda: fetch(self.call(self.inputs[0])), ctx.sync, ctx.traffic["warmup_steps"])
        ctx.mark("artifact warm-up")

    def step(self):
        i = self.calls
        j = self.due.get(i)
        if j is None:
            out = self.call(self.inputs[i % self.n_in])
        else:  # a compared call: its codes read from the operator's calls
            with _Codes() as tap:
                out = self.call(self.inputs[i % self.n_in])
            self.answers[j] = tuple(t.clone() for t in out)
            branch = next(iter(self.ctx.config.QUANTIZERS))
            self.codes[j] = {branch: tap.ids[0].reshape(out[0].shape[0], -1)} if len(tap.ids) == 1 else {}
        self.calls = i + 1
        return out


def setup(ctx):
    return ArtifactServing(ctx)
