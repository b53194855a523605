"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``reference/``), which works everything out again from
the inputs the benchmark made and the weights it drew. Only the numbers that
a cell's ``limits/<cell>.json`` compares are computed.

Training: the first three steps of the object the window then drives, and
one more step of it after the window closed, each through the window's own
call. The first three: the first step's loss (``loss_gap_first``); the norm
of each leaf's first gradient as Adam holds it after one step
(``exp_avg / (1 - beta1)``, ``grad_gap``); the norm of each leaf's change
after three steps (``change_gap``). The step after the window, from a
snapshot of the program's parameters and Adam's state taken just before
it, against the reference's step from that snapshot: its loss
(``post_loss_gap``) and each leaf's change, of which the median leaf's
counts (``post_median_change_gap``). A norm is compared by the gap between
the program's and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger, and in the first three steps
the worst leaf counts. A leaf whose reference gradient is under a
thousandth of the median leaf's moves under Adam by round-off alone and is
left out of the change; a leaf the reference leaves untouched must stay
bitwise where it was after three steps, and a leaf it does not train at all
(a frozen branch) still at the snapshot (``frozen_change``). The codes the
program's quantizers assigned in every recorded step (read by forward hooks
on them, ``config.QUANTIZERS``) against the reference's: a code counts as off where it differs from the
reference's and the reference's assignment is not within ``tie_margin`` of
a tie (there the nearest code is a matter of rounding); ``codes_off``
counts the (step, sample, branch) triples with such a code. The
on-the-fly cell adds its synthesized spectrograms of every recorded step
(per sample, the largest gap over the sample's largest value: the worst,
``synth_gap``, and the count of samples above ``synth_tol``,
``synth_samples_off``) and labels (``label_gap``); the cached cell
compares its cache's codes in place of the steps'.

Where the reference's nearest code is within ``tie_margin`` of a tie, it
takes the program's code of that step (its ``follow``): which code is
nearest there is a matter of rounding, and a code taken the other way would
move the loss, and through Adam every later step, by more than any fault of
the arithmetic. Everywhere else it takes its own, and ``codes_off`` judges
the program's.

Serving: every answer of a sample of calls drawn from the seed, one call of
each input batch, with the codes the call assigned. ``codes_off`` counts the
rows with a code off the reference's as above; ``answer_gap`` is the largest
gap of any row's angle (rad), radius or position (m) from the reference
head's answer from the codes the program assigned, so that a code flipped
at a tie does not excuse the row: every row is judged.

The reference runs in float64 once the window has closed and the program's
state is freed. The control runs the same reference in float32 with TF32 on
(``control=True``): the step that would tempt a later change.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Optional

import torch

from reference import model as ref
from reference import synth


@contextlib.contextmanager
def precision(control: bool, device: torch.device):
    """TF32 on for the control (real on the card, emulated on the CPU)."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = control and device.type == "cuda"
    try:
        with ref.tf32_emulated(control and device.type != "cuda"):
            yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


class TrainRecord:
    """What recorded steps produced: the program's, read as they ran, or the
    reference's."""

    def __init__(self):
        self.losses: List[float] = []
        self.grad_norms: Dict[str, float] = {}
        self.change_norms: Dict[str, float] = {}
        self.codes: List[Dict[str, torch.Tensor]] = []  # each step's ids (B, R) by branch
        self.margins: List[Dict[str, torch.Tensor]] = []  # the reference's: each id's tie margin
        self.batches: List[Dict[str, torch.Tensor]] = []  # on-the-fly: the program's synthesized batches


def record_step(rec: TrainRecord, i: int, trainer, params0: Dict[str, torch.Tensor], metrics) -> None:
    rec.losses.append(float(metrics["loss"]))
    named = dict(trainer.model.named_parameters())
    if i == 0:
        for k, p in named.items():
            st = trainer.optimizer.state.get(p)
            if st and "exp_avg" in st:
                rec.grad_norms[k] = float(torch.linalg.vector_norm(st["exp_avg"].double() / 0.1))
    if i == 2:
        rec.change_norms = change_norms(trainer.model, params0)


def change_norms(model: torch.nn.Module, since: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each parameter's change since ``since``."""
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm((p - since[k]).double())) for k, p in model.named_parameters()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)


def reference_train(config, cfg: dict, params0, batches: List[Dict[str, torch.Tensor]], jitters, lr: float,
                    dtype: torch.dtype, control: bool, device: torch.device, follow=None,
                    tie: float = 0.0, adam: Optional[Dict] = None) -> TrainRecord:
    """The reference's steps of the configuration module ``config`` from
    ``params0`` on ``batches`` (each a dict of the fields its loss reads),
    in ``dtype``; at each assignment within ``tie`` of a tie, the code of
    ``follow`` (each step's codes by branch, the program's). ``adam``
    (``m``, ``v`` by key and the step count ``t``) is Adam's state to start
    from; by default a fresh one."""
    p = {k: v.detach().to(dtype).clone() for k, v in params0.items()}
    for k in p:  # tied aliases share layer 0's tensor again
        p[k] = p[ref.tied_source(k)]
    keys = config.trained_keys(cfg, [k for k in p if ref.tied_source(k) == k])
    for k in keys:
        p[k].requires_grad_(True)
    opt = ref.Adam(p, keys, lr)
    if adam is not None:  # a leaf Adam holds no state of yet starts from zeros, as torch's does
        opt.t = adam["t"]
        for k in keys:
            if k in adam["m"]:
                opt.m[k] = adam["m"][k].detach().to(dtype).clone()
                opt.v[k] = adam["v"][k].detach().to(dtype).clone()
    out = TrainRecord()
    with precision(control, device):
        for i, batch in enumerate(batches):
            b = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}
            loss, metrics = config.loss(p, cfg, b, jitters[i] if jitters else None,
                                      follow[i] if follow and i < len(follow) else None, tie)
            codes = metrics.pop("codes", {})
            out.codes.append({k: v[0] for k, v in codes.items()})
            out.margins.append({k: v[1] for k, v in codes.items()})
            grads = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
            grads = dict(zip(keys, grads))
            out.losses.append(float(loss.detach()))
            if i == 0:
                out.grad_norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()
                                  if g is not None}
            with torch.no_grad():
                opt.step(grads)
    with torch.no_grad():
        out.change_norms = {k: float(torch.linalg.vector_norm((p[k].double() - params0[k].double()))) for k in keys}
    return out


def _change_gaps(prog: TrainRecord, want: TrainRecord) -> List[float]:
    """Each leaf's change gap, over the leaves the reference's first
    gradient moves."""
    g_ref = {k: v for k, v in want.grad_norms.items() if v > 0}
    med_g = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med_g]
    med_c = statistics.median(want.change_norms[k] for k in moved)
    return [abs(prog.change_norms.get(k, 0.0) - want.change_norms[k]) / max(want.change_norms[k], med_c)
            for k in moved]


def _frozen(changes: Dict[str, float], want: TrainRecord) -> float:
    """The largest change of a leaf that the reference's gradient leaves
    untouched."""
    return max((v for k, v in changes.items() if not want.grad_norms.get(k)), default=0.0)


def train_numbers(prog: TrainRecord, want: TrainRecord) -> Dict[str, float]:
    """The numbers compared for the first three steps of a training cell."""
    g_ref = {k: v for k, v in want.grad_norms.items() if v > 0}
    med_g = statistics.median(g_ref.values())
    return {
        "loss_gap_first": _rel(prog.losses[0], want.losses[0]),
        "grad_gap": max(abs(prog.grad_norms.get(k, 0.0) - v) / max(v, med_g) for k, v in g_ref.items()),
        "change_gap": max(_change_gaps(prog, want)),
        "frozen_change": _frozen(prog.change_norms, want),
    }


def post_numbers(prog: TrainRecord, want: TrainRecord) -> Dict[str, float]:
    """The numbers compared for the step after the window: its loss and the
    median leaf's change gap from the snapshot (the worst leaf's swings
    with the steps trained: some leaves' gradients have fallen to their
    round-off by then)."""
    return {"post_loss_gap": _rel(prog.losses[0], want.losses[0]),
            "post_median_change_gap": statistics.median(_change_gaps(prog, want))}


def untrained_change(since_start: Dict[str, float], want: TrainRecord) -> float:
    """The largest change since the start (``since_start``) of a leaf that
    the reference does not train (no gradient: a frozen branch)."""
    return max((v for k, v in since_start.items() if k not in want.grad_norms), default=0.0)


def synth_numbers(got_batches, draws, geometry: dict, tol: float) -> Dict[str, float]:
    """Synthesized batches against the float64 reference synthesis of the
    same draws: the spectrogram gap per sample over the sample's largest
    value, the worst (``synth_gap``) and ``synth_samples_off``, the samples
    above ``tol``; and the labels exactly (``label_gap``)."""
    per_sample, label_gap = [], 0.0
    for got, d in zip(got_batches, draws):
        want = synth.samples(as_dtype(d, torch.float64), geometry)
        e_w, e_g = want["echoed_spec"], got["echoed_spec"].double()
        if e_g.shape != e_w.shape:
            per_sample += [math.inf] * e_w.shape[0]
            continue
        per_sample += ((e_g - e_w).abs().amax(dim=(1, 2)) / e_w.abs().amax(dim=(1, 2))).tolist()
        for k in ("theta", "radius"):
            label_gap = max(label_gap, float((got[k].double() - want[k]).abs().max()))
    return {"synth_gap": max(per_sample), "synth_samples_off": float(sum(v > tol for v in per_sample)),
            "label_gap": label_gap}


def as_dtype(d: Dict, dtype: torch.dtype) -> Dict:
    """The floating tensors of ``d`` in ``dtype``."""
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v) for k, v in d.items()}


def control_batches(draws, geometry: dict, device: torch.device):
    """The control's synthesis of ``draws``: the reference in float32, TF32 on."""
    with torch.no_grad(), precision(True, device):
        return [synth.samples(as_dtype(d, torch.float32), geometry) for d in draws]


def codes_numbers(got: List[Dict[str, torch.Tensor]], want: List[Dict[str, torch.Tensor]],
                  margins: List[Dict[str, torch.Tensor]], steps: int, tie: float) -> Dict[str, float]:
    """The program's codes ``got`` of the first ``steps`` steps against the
    reference's ``want`` with their tie ``margins`` (each a dict by branch of
    (B, R) tensors): ``codes_off``, the (step, sample, branch) triples with a
    code that differs at an assignment not within ``tie`` of a tie (a
    branch's codes missing or of another shape count every sample off)."""
    off = 0
    for i in range(steps):
        for name, ids in want[i].items():
            g = got[i].get(name) if i < len(got) else None
            if g is None or g.numel() != ids.numel():
                off += ids.shape[0]
                continue
            diff = g.reshape(ids.shape).to(ids.device).long() != ids.long()
            off += int((diff & (margins[i][name].to(ids.device) >= tie)).any(dim=1).sum())
    return {"codes_off": float(off)}


def serve_reference(config, cfg: dict, geometry: dict, params0, inputs: torch.Tensor, codes, dtype: torch.dtype,
                    control: bool, device: torch.device, block: int = 64):
    """The reference's view of each input batch of ``inputs`` (n, B, F, T),
    in ``dtype``, in blocks of rows: ``(its answers, its codes, their tie
    margins, the answers from codes)``, each answer ``(theta, radius,
    coords)``; ``codes`` (a list of (B, R), an entry or the whole None for
    the reference's own) are the codes the last answers are worked out
    from."""
    p = {k: v.detach().to(dtype) for k, v in params0.items()}
    out = []
    with torch.no_grad(), precision(control, device):
        for j, x in enumerate(inputs):
            given = None if codes is None else codes[j]
            if given is not None and given.shape[0] != x.shape[0]:
                given = None  # the wrong shape is for codes_off to count
            parts = [config.answers(p, cfg, geometry, x[i: i + block].to(dtype),
                                  None if given is None else given[i: i + block])
                     for i in range(0, x.shape[0], block)]
            cat = lambda k: tuple(torch.cat([q[k][m] for q in parts]) for m in range(3))
            out.append((cat(0), torch.cat([q[1] for q in parts]), torch.cat([q[2] for q in parts]), cat(3)))
    return out


def serve_numbers(answers, codes, ref, tie: float) -> Dict[str, float]:
    """Served ``answers`` [(theta, radius, coords)] and the ``codes`` [(B,
    R) or None] they were served with, against the float64 reference's
    :func:`serve_reference` from those codes: ``answer_gap``, the largest
    gap of any row's angle (rad), radius or position (m) from the
    reference's answer from the same codes; ``codes_off`` as
    :func:`codes_numbers` (here rows of a call)."""
    gap = 0.0
    for (th, r, c), (_, _, _, (t_w, r_w, c_w)) in zip(answers, ref):
        dt = torch.remainder(th.double().to(t_w.device) - t_w + math.pi, 2 * math.pi) - math.pi
        dr = r.double().to(r_w.device) - r_w
        dc = c.double().to(c_w.device) - c_w
        gap = max(gap, float(dt.abs().max()), float(dr.abs().max()), float(dc.abs().max()))
    out = {"answer_gap": gap}
    out.update(codes_numbers([{} if c is None else {"codes": c} for c in codes], [{"codes": w[1]} for w in ref],
                             [{"codes": w[2]} for w in ref], len(ref), tie))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number without a limit is
    reported and not compared."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
