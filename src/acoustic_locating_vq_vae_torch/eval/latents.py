"""Latent-space analysis: the t-SNE study of echoe_transfer.py (C23).

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/latents.py:22-118``:
collects the flattened one-hot VQ encodings of the RIR and speech branches of
a trained composite over a dataset (:func:`collect_encodings`), measures how
much source angle is linearly decodable from a representation
(:func:`linear_angle_probe`, the same float64 ridge probe in dual form), and
embeds the RIR encodings with t-SNE (:func:`tsne_rir_embedding`, which needs
scikit-learn and imports it only when called).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..data.synth import SampleBatch
from ..dsp.specs import znorm
from ..utils.device import full_fp32, resolve_device

__all__ = ["collect_encodings", "linear_angle_probe", "tsne_rir_embedding"]


def _branches(task, composite_params: Mapping[str, torch.Tensor], device: torch.device):
    """The RIR and speech branches of the composite ``task`` builds
    (``build_composite``), with the weights of ``composite_params`` (a
    composite state dict: ``rir_model.*``, ``speech_model.*``) on ``device``,
    in eval mode; the decoders, which the encodings never run, are dropped
    (a freshly grafted composite may have none)."""
    with torch.device("meta"):  # no weights are drawn only to be overwritten
        composite = task.build_composite()
    branches = []
    for name in ("rir_model", "speech_model"):
        module = getattr(composite, name)
        module._decoder = None
        prefix = name + "."
        module.load_state_dict(
            {k[len(prefix):]: torch.as_tensor(v).to(device, torch.float32, copy=True)
             for k, v in composite_params.items() if k.startswith(prefix) and not k.startswith(prefix + "_decoder.")},
            assign=True,
        )
        branches.append(module.eval().requires_grad_(False))
    return tuple(branches)


def collect_encodings(
    task, composite_params: Mapping[str, torch.Tensor], batch: SampleBatch, batch_size: int = 64,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """Per-sample flattened one-hot encodings of both branches
    (echoe_transfer.py:41-60): ``rir_encodings`` (n, rows_r * K_r),
    ``speech_encodings`` (n, rows_s * K_s) and ``theta`` (n,), as numpy
    arrays. The echoed spectrogram is z-normed over frequency, the RIR branch
    reads its transpose; chunks of ``batch_size`` samples run on ``device``
    with the codebooks frozen and TF32 off."""
    dev = resolve_device(device)
    rir, speech = _branches(task, composite_params, dev)
    n = int(batch.speech_spec.shape[0])
    rir_list, speech_list = [], []
    with torch.no_grad(), full_fp32():
        for i in range(0, n, batch_size):
            x = znorm(torch.as_tensor(batch.echoed_spec[i:i + batch_size]).to(dev, torch.float32), dim=1)
            enc_r = rir.get_latent_representation(x.transpose(1, 2))[3]
            enc_s = speech.get_latent_representation(x)[3]
            b = x.shape[0]
            rir_list.append(enc_r.reshape(b, -1).cpu().numpy())
            speech_list.append(enc_s.reshape(b, -1).cpu().numpy())
    return {
        "rir_encodings": np.concatenate(rir_list),
        "speech_encodings": np.concatenate(speech_list),
        "theta": torch.as_tensor(batch.theta).reshape(-1).cpu().numpy(),
    }


def linear_angle_probe(
    feats_train: np.ndarray,
    theta_train: np.ndarray,
    feats_test: np.ndarray,
    theta_test: np.ndarray,
    ridge_lambda: float = 10.0,
) -> Dict[str, float]:
    """Ridge linear probe features -> (sin theta, cos theta), dual form.

    How much source-angle information is linearly decodable from a latent
    representation (the JAX package's VALIDATION.md round-2 latent study).
    The dual (kernel) form keeps high-dimensional features cheap: it solves
    (K + lambda I) alpha = Y with K = X X^T, in float64.

    Returns {"r2": held-out R^2 on the (sin, cos) targets,
             "angle_rmse_radians": wrap-aware RMSE of atan2-decoded angles}.
    """
    Xtr = np.asarray(feats_train, dtype=np.float64)
    Xte = np.asarray(feats_test, dtype=np.float64)
    ttr = np.asarray(theta_train).reshape(-1)
    tte = np.asarray(theta_test).reshape(-1)
    if len(tte) < 2 or len(ttr) < 2:
        raise ValueError(f"linear_angle_probe needs >=2 train and test samples, got {len(ttr)}/{len(tte)}")
    Xtr = Xtr.reshape(Xtr.shape[0], -1)
    Xte = Xte.reshape(Xte.shape[0], -1)
    mu = Xtr.mean(axis=0)
    Xtr = Xtr - mu
    Xte = Xte - mu
    Ytr = np.stack([np.sin(ttr), np.cos(ttr)], axis=1)
    Yte = np.stack([np.sin(tte), np.cos(tte)], axis=1)
    K = Xtr @ Xtr.T
    alpha = np.linalg.solve(K + ridge_lambda * np.eye(K.shape[0]), Ytr)
    pred = (Xte @ Xtr.T) @ alpha
    ss_res = float(((pred - Yte) ** 2).sum())
    ss_tot = float(((Yte - Ytr.mean(axis=0)) ** 2).sum())
    if ss_tot == 0.0:
        raise ValueError("degenerate test split: constant (sin, cos) targets")
    ang_err = np.angle(np.exp(1j * (np.arctan2(pred[:, 0], pred[:, 1]) - tte)))
    return {"r2": 1.0 - ss_res / ss_tot, "angle_rmse_radians": float(np.sqrt(np.mean(ang_err**2)))}


def tsne_rir_embedding(
    task, composite_params: Mapping[str, torch.Tensor], batch: SampleBatch, perplexity: float = 30.0,
    seed: int = 0, device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """2-D t-SNE of the RIR encodings and the angles to colour them by
    (echoe_transfer.py:66-71). Needs scikit-learn."""
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError("tsne_rir_embedding needs scikit-learn (sklearn.manifold.TSNE), which is not "
                          "installed; collect_encodings and linear_angle_probe do not") from e

    enc = collect_encodings(task, composite_params, batch, device=device)
    n = enc["rir_encodings"].shape[0]
    emb = TSNE(
        n_components=2, perplexity=min(perplexity, max(2.0, (n - 1) / 3)), random_state=seed
    ).fit_transform(enc["rir_encodings"])
    return emb, enc["theta"]
