"""Loop ``codec_serve``: one caller in a closed loop over the program's codec
serving closure (``eval/serving.py:make_codec_serving_fn``), each call a
batch of ``batch`` waveforms taken in turn from ``pool_batches`` distinct
batches resident on the card, each call timed from a synchronised device
until its codes and audio are synchronised and fetched to the host (the
``serve`` loop's discipline).

The waveforms are echoed speech made at set-up by the port's own synthesis
(``data/synth.py``: ``draw_synthesis`` and ``echoed_from_draws``, the draws
and RIRs ``synthesize_batch`` makes its spectrograms of) at the
configuration's geometry; so is a separate batch whose latents, worked out by
the reference, seed the codebooks (``configs/<config>.py:prepare``).

The check: for each input batch one compared call, drawn from the seed
among its first ``compare_within`` calls, whose encoder output (read by a
hook on the encoder's last layer for that call alone), codes and audio are
kept. Against the float64 reference once the window has closed:
``encoder_gap``, the worst clip's largest gap of the latent over the
reference's largest value; ``codes_off``, codes that differ from the
reference's nearest along the program's own earlier codes and are not within
``tie_margin`` of a tie (``reference/encodec.py:judge_codes``), with
``codes_differ`` and ``tie_gap_max`` the exact disagreements and their
largest gap, reported and not compared; ``audio_gap``, the worst clip's
largest gap of the decoded audio from the reference decoder's on the same
codes, over that clip's peak. The control is the reference in float32 with
TF32 on in the program's place.

A run at reduced width (the tests' CPU runs, ``width_scale`` below 1) draws
the weights at the cut widths, cuts the RIR by the same factor and the clip
to a quarter (:func:`geometry`); at width 1 the configuration is run as it
is.

Faults: ``frozen_state`` (every call returns the warm-up's first outputs),
``half_batch`` (the second half of each call's clips given the first
half's outputs).
"""

from __future__ import annotations

import math
import sys

import torch

from harness import check
from harness.cell import check_shapes, sub_seed
from harness.inputs import spectrograms
from harness.weights import make_params
from harness.window import Loop, timed_calls, warm_up
from reference import encodec as ref

# the program's modules this loop calls: imported in the set-up's import phase
PROGRAM = ("acoustic_locating_vq_vae_torch.eval.serving", "acoustic_locating_vq_vae_torch.data.synth")


def fetch(out) -> float:
    """The outputs' sum on the host: one read that waits for every output."""
    return float(sum(torch.sum(t) for t in out))


def geometry(cfg: dict, width_scale: float) -> dict:
    """The synthesis geometry of a run at reduced width: the RIR cut by
    ``width_scale``, the clip to a quarter."""
    geo = cfg["geometry"]
    return {**geo, "n_sample": max(64, int(geo["n_sample"] * width_scale)), "audio_samples": geo["audio_samples"] // 4}


class CodecServing(Loop):
    def __init__(self, ctx):
        super().__init__(ctx)
        from acoustic_locating_vq_vae_torch.data.config import DatasetConfig
        from acoustic_locating_vq_vae_torch.eval.serving import make_codec_serving_fn

        t = ctx.traffic
        cfg = ctx.config.scaled(ctx.cfg, ctx.width_scale)
        if cfg is not ctx.cfg:  # a run at reduced width: the harness drew the published widths
            cfg["geometry"] = geometry(cfg, ctx.width_scale)
            ctx.params = make_params(ctx.config, cfg, ctx.gen, spectrograms(ctx.gen, 1, cfg["geometry"]))
            ctx.cfg = cfg
        self.geo = DatasetConfig(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["geometry"].items()})
        ctx.config.prepare(ctx.params, cfg, self.clips(ctx.config.seed_clips(cfg)), ctx.gen)
        ctx.mark("codebooks")
        self.serve = make_codec_serving_fn(ctx.port_task, ctx.params, device=ctx.device)
        model = self.serve.modules[0]
        check_shapes(model, ctx.params)
        self.call = self.serve
        ctx.mark("serving closure")
        self.n_in = n_in = t["pool_batches"]
        self.inputs = torch.stack([self.clips(ctx.batch) for _ in range(n_in)])
        picks = torch.randint(t["compare_within"], (n_in,),
                              generator=torch.Generator().manual_seed(sub_seed(ctx.seed, 5))).tolist()
        self.due = {j + n_in * k: j for j, k in enumerate(picks)}  # call index -> input batch compared
        self.kept, self.calls, self.latent = {}, 0, None
        self.last = model.encoder.layers[-1]  # its output is the latent the quantizer reads
        ctx.mark("input pool")
        if ctx.fault == "frozen_state":
            first = tuple(o.clone() for o in self.serve(self.inputs[0]))
            self.call = lambda x: first
        elif ctx.fault == "half_batch":
            def half(x):
                h = x.shape[0] // 2
                return tuple(torch.cat([o[:h], o[:h]])[: x.shape[0]] for o in self.serve(x))

            self.call = half
        warm_up(lambda: fetch(self.call(self.inputs[0])), ctx.sync, t["warmup_steps"])
        ctx.mark("warm-up")
        self.counts = ctx.config.counts(cfg, "serve", ctx.batch)

    def clips(self, n: int) -> torch.Tensor:
        """``n`` echoed waveforms (n, audio_samples) from the run's generator."""
        from acoustic_locating_vq_vae_torch.data.synth import draw_synthesis, echoed_from_draws

        return echoed_from_draws(draw_synthesis(self.ctx.gen, n, self.geo), self.geo)

    def _keep(self, module, args, output) -> None:
        self.latent = output.detach().clone()

    def step(self):
        i = self.calls
        j = self.due.get(i)
        if j is None:
            out = self.call(self.inputs[i % self.n_in])
        else:  # a compared call: its latent read by a hook that exists for this call alone
            self.latent, hook = None, self.last.register_forward_hook(self._keep)
            out = self.call(self.inputs[i % self.n_in])
            hook.remove()
            self.kept[j] = (self.latent, out[0].clone(), out[1].clone())
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
        while len(self.kept) < self.n_in:
            self.step()
        self.ctx.sync()

    def release(self) -> None:
        del self.serve, self.call, self.last

    def check(self, control: bool):
        order = sorted(self.kept)
        got = [self.kept[j] for j in order]
        numbers = self.numbers([g[0] for g in got], [g[1] for g in got], [g[2] for g in got], order)
        print(f"codes_differ {numbers.get('codes_differ')!r} tie_gap_max {numbers.get('tie_gap_max')!r} "
              f"(reported, not compared)", file=sys.stderr)
        if not control:
            return numbers, None
        c = [self.reference(self.inputs[j], torch.float32, True) for j in order]
        return numbers, self.numbers([w[0] for w in c], [w[1] for w in c], [w[2] for w in c], order)

    def reference(self, x: torch.Tensor, dtype: torch.dtype, control: bool, block: int = 32):
        """The reference's (latent, codes, audio) of the clips ``x`` in ``dtype``."""
        cfg, n_q = self.ctx.cfg, ref.quantizers_for_bandwidth(self.ctx.cfg, self.ctx.cfg["bandwidth"])
        p = {k: v.detach().to(dtype) for k, v in self.ctx.params.items()}
        parts = []
        with torch.no_grad(), check.precision(control, self.ctx.device):
            for i in range(0, x.shape[0], block):
                xb = x[i: i + block].to(dtype)
                z = ref.encoder(p, xb[:, None], cfg)
                codes = ref.rvq_encode(p, z, n_q)
                parts.append((z, codes, ref.decode(p, codes, cfg, xb.shape[-1])))
        return tuple(torch.cat([q[m] for q in parts]) for m in range(3))

    def numbers(self, latents, codes, audio, order, block: int = 32):
        """The compared numbers of each input batch's (latent, codes, audio)
        against the float64 reference (its encoder, its judgement of the
        codes, its decoder on the same codes)."""
        ctx, cfg = self.ctx, self.ctx.cfg
        p = {k: v.detach().double() for k, v in ctx.params.items()}
        tie = ctx.limits["tie_margin"]
        enc = aud = worst = 0.0
        off = differ = 0
        with torch.no_grad(), check.precision(False, ctx.device):
            for j, z_got, c_got, a_got in zip(order, latents, codes, audio):
                for i in range(0, self.inputs.shape[1], block):
                    x = self.inputs[j][i: i + block].double()
                    z = ref.encoder(p, x[:, None], cfg)
                    if z_got is None or z_got[i: i + block].shape != z.shape:  # the call ran no encoder
                        return {"encoder_gap": math.inf, "codes_off": math.inf, "audio_gap": math.inf}
                    zg = z_got[i: i + block].double().to(z.device)
                    enc = max(enc, float(((zg - z).abs().amax(dim=(1, 2)) / z.abs().amax(dim=(1, 2))).max()))
                    c = c_got[i: i + block].to(z.device)
                    o, d, w = ref.judge_codes(p, z, c, tie)
                    off, differ, worst = off + o, differ + d, max(worst, w)
                    want = ref.decode(p, c, cfg, x.shape[-1])
                    ag = a_got[i: i + block].double().to(want.device)
                    aud = max(aud, float(((ag - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max()))
        return {"encoder_gap": enc, "codes_off": float(off), "audio_gap": aud, "codes_differ": float(differ),
                "tie_gap_max": worst}


def setup(ctx):
    return CodecServing(ctx)
