"""Location-model evaluation and comparison.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/compare.py:38-267``, the
evident intent of the reference's broken ``compare_location_models.py``:
evaluate one or more (composite, location head) pairs on a dataset, with the
same metric names as the JAX package:

  * MSE / RMSE on the normalized angle theta/pi (the training target,
    train_location.py:77-78), wrap-aware;
  * the angular error in radians: RMSE, median, p90, and the shares above
    0.1 rad and 1 rad;
  * RMSE of the 3-D source coordinates (specsdataset.py:38-45);
  * for a head with a range output, the RMSE and median error of the radius.

Weights are the port's state dicts; the head predicts in full float32 on
``device`` (the card unless ``device="cpu"``), in chunks of ``batch_size``;
the RIR branch's convs run in the task's ``compute_dtype``.
The metrics are computed on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..data.synth import SampleBatch
from ..dsp.specs import source_coordinates
from ..train.tasks import JointLocationTask, LocationTask
from ..utils.device import full_fp32, resolve_device
from .serving import _load

__all__ = [
    "evaluate_location",
    "evaluate_joint_location",
    "compare_location_models",
    "infer_location_modes",
    "infer_target_mode",
]

StateDict = Mapping[str, torch.Tensor]


def infer_location_modes(loc_params: StateDict, task: LocationTask) -> Dict[str, str]:
    """The (input_mode, target_mode) a location head was trained with, from
    its state dict's shapes, given a task carrying the geometry config:
    ``fc_1``'s input width is ``num_freq * D_rir`` for quantized features and
    ``num_freq * K`` for one-hot encodings; ``fc_5`` emits 2 values for the
    circular (sin, cos) target and 1 for theta/pi."""
    in_dim = loc_params["fc_1.weight"].shape[1]
    f = task.config.num_freq
    quant_width = dataclasses.replace(task, input_mode="quantized").feature_width
    enc_width = dataclasses.replace(task, input_mode="encodings").feature_width
    if quant_width == enc_width and in_dim == f * enc_width:
        # both widths floored to the same value: the shape cannot tell the
        # modes apart, so refuse rather than feed the wrong features
        raise ValueError(
            f"location head fc_1 in-width {in_dim} is ambiguous: quantized and "
            f"encodings features both have width {enc_width} at this "
            f"width_scale; pass the input mode explicitly (--location-input-mode)"
        )
    if in_dim == f * quant_width:
        input_mode = "quantized"
    elif in_dim == f * enc_width:
        input_mode = "encodings"
    else:
        raise ValueError(
            f"location head fc_1 in-width {in_dim} matches neither "
            f"quantized ({f * quant_width}) nor encodings ({f * enc_width}) "
            f"features for this config"
        )
    return {"input_mode": input_mode, "target_mode": infer_target_mode(loc_params)}


def infer_target_mode(head_params: StateDict) -> str:
    """Target mode of a location head (the frozen stage's head, or the joint
    model, whose head is under ``head.``), from its output width: ``fc_5``
    emits 2 values for the circular (sin, cos) target, 1 for theta/pi."""
    key = "fc_5.weight" if "fc_5.weight" in head_params else "head.fc_5.weight"
    return "sincos" if head_params[key].shape[0] == 2 else "normalized_angle"


def _angle_error_metrics(ang: np.ndarray) -> Dict[str, float]:
    """Wrap-aware angular-error summary: the RMSE with robust companions (the
    median, a p90, the share of errors above 0.1 rad, and of gross
    confusions above 1 rad)."""
    a = np.abs(ang)
    return {
        "rmse_radians": float(np.sqrt(np.mean(ang**2))),
        "median_abs_radians": float(np.median(a)),
        "p90_abs_radians": float(np.percentile(a, 90)),
        "frac_err_gt_0.1rad": float(np.mean(a > 0.1)),
        "frac_err_gt_1rad": float(np.mean(a > 1.0)),
    }


def _predict(fn: Callable[[torch.Tensor], torch.Tensor], batch: SampleBatch, device: torch.device,
             batch_size: int) -> np.ndarray:
    """``fn`` over the batch's echoed spectrograms in chunks, in full float32."""
    spec = torch.as_tensor(batch.echoed_spec)
    preds = []
    with torch.no_grad(), full_fp32():
        for i in range(0, spec.shape[0], batch_size):
            preds.append(fn(spec[i : i + batch_size].to(device, torch.float32)).cpu().numpy())
    return np.concatenate(preds, axis=0)


def _host(a) -> np.ndarray:
    return torch.as_tensor(a).detach().cpu().numpy()


def _coords(task, theta: np.ndarray, radius: Union[np.ndarray, float]) -> np.ndarray:
    cfg = task.config
    t = torch.from_numpy(np.asarray(theta, np.float32))
    r = torch.as_tensor(np.asarray(radius, np.float32))
    return source_coordinates(t, cfg.receiver_position, cfg.room_dimensions, r, cfg.Z_LOC_SOURCE).numpy()


def evaluate_location(
    task: LocationTask,
    location_params: StateDict,
    composite_params: StateDict,
    batch: SampleBatch,
    batch_size: int = 64,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Evaluate one frozen location model over a SampleBatch:
    ``location_params`` is the head's state dict, ``composite_params`` the
    composite's (whose RIR branch the head reads)."""
    device = resolve_device(device)
    head = _load(task.build_model, location_params, device)
    rir = task.build_frozen(composite_params, device)
    pred = _predict(lambda spec: head(task.encodings_from_composite(rir, spec)), batch, device, batch_size)
    cfg = task.config
    n = pred.shape[0]
    theta_true = _host(batch.theta).astype(np.float32).reshape(-1)

    if task.target_mode == "sincos":
        theta_pred = np.arctan2(pred[:, 0], pred[:, 1])
        ang = np.angle(np.exp(1j * (theta_pred - theta_true)))
        # true geometry at the batch's per-sample radius; the frozen head has
        # no range output, so the predicted position sits on the config's circle
        coords_true = _coords(task, theta_true, _host(batch.radius).reshape(-1))
        coords_pred = _coords(task, theta_pred, cfg.R)
        return {
            "mse_theta_over_pi": float(np.mean((ang / np.pi) ** 2)),
            "rmse_theta_over_pi": float(np.sqrt(np.mean((ang / np.pi) ** 2))),
            **_angle_error_metrics(ang),
            "rmse_coordinates_m": float(np.sqrt(np.mean(np.sum((coords_pred - coords_true) ** 2, axis=1)))),
            "num_samples": int(n),
        }
    coords_true = _coords(task, theta_true, cfg.R)
    if task.output_dim == 1:
        theta_pred = pred.reshape(-1) * np.pi
        err_norm = pred.reshape(-1) - theta_true / np.pi
        ang = np.angle(np.exp(1j * (theta_pred - theta_true)))
        coords_pred = _coords(task, theta_pred, cfg.R)
        return {
            "mse_theta_over_pi": float(np.mean(err_norm**2)),
            "rmse_theta_over_pi": float(np.sqrt(np.mean(err_norm**2))),
            **_angle_error_metrics(ang),
            "rmse_coordinates_m": float(np.sqrt(np.mean(np.sum((coords_pred - coords_true) ** 2, axis=1)))),
            "num_samples": int(n),
        }
    # 3-D coordinate regression variant
    return {
        "rmse_coordinates_m": float(np.sqrt(np.mean(np.sum((pred - coords_true) ** 2, axis=1)))),
        "num_samples": int(n),
    }


def evaluate_joint_location(
    task: JointLocationTask,
    params: StateDict,
    batch: SampleBatch,
    batch_size: int = 64,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Evaluate a joint localizer (encoder + head, one state dict) over a
    SampleBatch, with the metrics of :func:`evaluate_location`."""
    device = resolve_device(device)
    model = _load(task.build_model, params, device)
    pred = _predict(lambda spec: model(*task.model_inputs(spec))[0], batch, device, batch_size)
    cfg = task.config
    n = pred.shape[0]
    theta_true = _host(batch.theta).astype(np.float32).reshape(-1)
    pred_t = torch.from_numpy(pred)
    theta_pred = task.decode_angle(pred_t).numpy()
    ang = np.angle(np.exp(1j * (theta_pred - theta_true)))
    # true geometry at the batch's per-sample radius; predicted at the head's
    # range output where it has one, else the config's fixed R
    r_true = _host(batch.radius).astype(np.float32).reshape(-1)
    r_pred = task.decode_radius(pred_t).numpy() if task.predict_radius else np.full_like(r_true, cfg.R)
    coords_true = _coords(task, theta_true, r_true)
    coords_pred = _coords(task, theta_pred, r_pred)
    loc_pred = pred[:, :-1] if task.predict_radius else pred
    if task.target_mode == "sincos":
        err_norm_sq = (ang / np.pi) ** 2
    else:
        err_norm_sq = (loc_pred[:, 0] - theta_true / np.pi) ** 2
    out = {
        "mse_theta_over_pi": float(np.mean(err_norm_sq)),
        "rmse_theta_over_pi": float(np.sqrt(np.mean(err_norm_sq))),
        **_angle_error_metrics(ang),
        "rmse_coordinates_m": float(np.sqrt(np.mean(np.sum((coords_pred - coords_true) ** 2, axis=1)))),
        "num_samples": int(n),
    }
    if task.predict_radius:
        out["rmse_radius_m"] = float(np.sqrt(np.mean((r_pred - r_true) ** 2)))
        out["median_abs_radius_m"] = float(np.median(np.abs(r_pred - r_true)))
    return out


def compare_location_models(
    entries: Dict[str, Dict[str, Any]],
    batch: SampleBatch,
    task: Optional[LocationTask] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Compare named frozen location models, e.g. the frozen-encoder against
    the fine-tuned composite (the reference script's purpose).
    ``entries[name]`` holds ``{"location_params", "composite_params",
    "task"?}``."""
    out = {}
    for name, e in entries.items():
        t = e.get("task", task)
        if t is None:
            raise ValueError(f"entry {name!r} needs a LocationTask")
        out[name] = evaluate_location(t, e["location_params"], e["composite_params"], batch, device=device)
    return out
