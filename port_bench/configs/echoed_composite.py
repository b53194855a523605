"""Configuration ``echoed_composite``: the reference's echoed-speech stage
(``scripts/train_echoed_speech.py``). Two frozen conv VQ-VAE encoders, the
speech branch over time and the RIR branch over frequency, both with the
memory-order VQ flatten, feed the trained decoder, which reconstructs the
z-normed echoed spectrogram.

The harness loads this module by the configuration's name, beside its file
of sizes (``echoed_composite.json``): the program's task object, the
state-dict layout the benchmark's weights are drawn in, the FLOPs of a step,
and the reference's loss (``reference/model.py``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from harness import flops
from reference import model as ref

# the program's quantizers whose codes the check compares, by branch
QUANTIZERS = {"speech": "speech_model._vq", "rir": "rir_model._vq"}
# the recorded steps whose codes are compared: the branches are frozen, so all three
CODE_STEPS = 3


def build(cfg: dict, geo, width_scale: float):
    """The program's ``EchoedSpeechTask`` of the configuration."""
    from acoustic_locating_vq_vae_torch.train.tasks import EchoedSpeechTask

    return EchoedSpeechTask(config=geo, width_scale=width_scale, batch_size=cfg["train_batch"],
                            learning_rate=cfg["learning_rate"])


def param_spec(cfg: dict):
    """``(key, shape, init, fan_in)`` of every state-dict entry, under the
    program's (the reference's) keys."""
    dec = cfg["decoder"]
    spec = ref.vqvae_spec("rir_model.", cfg["rir"], decoder=True, decoder_out=1)
    spec += ref.vqvae_spec("speech_model.", cfg["speech"], decoder=True)
    spec += ref.decoder_spec("_decoder.", cfg["speech"]["embedding_dim"] + cfg["rir"]["embedding_dim"],
                             dec["num_hiddens"], dec["num_residual_hiddens"], dec["num_residual_layers"],
                             dec["out_channels"])
    return spec


def codebook_inputs(cfg: dict, x: torch.Tensor):
    """``(prefix, branch, input, memory order)`` of each codebook, from a
    z-normed batch ``x`` (B, F, T)."""
    return [("speech_model.", cfg["speech"], x, True), ("rir_model.", cfg["rir"], x.transpose(1, 2), True)]


def trained_keys(cfg: dict, keys: List[str]) -> List[str]:
    """The decoder alone: both branches are frozen."""
    return [k for k in keys if k.startswith("_decoder.")]


def counts(cfg: dict, kind: str, batch: int) -> Dict:
    """FLOPs of one step of ``batch`` rows, ``kind`` ``train`` (both
    encoders forward, the decoder trained) or ``train_cached`` (the decoder
    alone): ``model``, ``conv`` and the assignment calls ``vq_calls``
    [(N, D, K)]. Synthesis, where a step makes its batch, is not counted."""
    frames, bins = cfg["geometry"]["num_frames"], cfg["geometry"]["NFFT"] // 2 + 1
    sp, rr, dec = cfg["speech"], cfg["rir"], cfg["decoder"]
    conv = flops.trained(flops.decoder_layers(batch, frames, sp["embedding_dim"] + rr["embedding_dim"], dec))
    if kind == "train_cached":
        return {"model": conv, "conv": conv, "vq_calls": []}
    if kind != "train":
        raise ValueError(f"no {kind!r} count for {__name__}")
    conv += sum(flops.encoder_layers(batch, frames, sp)) + sum(flops.encoder_layers(batch, bins, rr))
    # memory-order flatten: B*L rows of D either way
    return {"model": conv + flops.vq_flops(batch * frames, sp) + flops.vq_flops(batch * bins, rr), "conv": conv,
            "vq_calls": [(batch * frames, sp["embedding_dim"], sp["num_embeddings"]),
                         (batch * bins, rr["embedding_dim"], rr["num_embeddings"])]}


def loss(p, cfg: dict, batch: Dict[str, torch.Tensor], jit, follow=None, tie: float = 0.0):
    """The reference's loss of one step and its metrics (``codes`` among
    them); at an assignment within ``tie`` of a tie, the code of ``follow``
    (the program's, by branch)."""
    return ref.echoed_loss(p, cfg, batch["echoed_spec"], jit, follow, tie)
