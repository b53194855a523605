"""The localizer's serving closure: echoed power spectrogram in, (angle,
source radius, 3-D coordinates) out.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/serving.py:91-152``
``make_serving_fn`` with ``from_audio=False``; the STFT frontend, the
artifact export and the store reading come in later slices. Weights enter as
the port's state dicts (see ``eval/weights.py:params_from_jax``). A task with
``compute_dtype="bfloat16"`` serves its RIR branch's convs in bf16, as JAX's
closure does through ``task.build_model()`` (JAX ``serving.py:112``); the VQ
assignment and the head stay full float32 (``full_fp32``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data.config import DatasetConfig
from ..dsp.specs import source_coordinates
from ..train.tasks import JointLocationTask, LocationTask
from ..utils.device import full_fp32, resolve_device

__all__ = ["make_serving_fn", "full_fp32", "resolve_device"]

StateDict = Mapping[str, Union[torch.Tensor, np.ndarray]]


def _load(build: Callable[[], torch.nn.Module], params: StateDict, device: torch.device) -> torch.nn.Module:
    # built on the meta device: no weights are drawn only to be overwritten
    with torch.device("meta"):
        module = build()
    module.load_state_dict(
        {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()}, assign=True
    )
    return module.to(device).eval()


def make_serving_fn(
    task: Union[JointLocationTask, LocationTask],
    params: StateDict,
    config: DatasetConfig,
    composite_params: Optional[StateDict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Build ``serve(spec)``: an echoed power spectrogram ``(B, num_freq,
    num_frames)`` -> ``(theta_rad (B,), radius_m (B,), coords_m (B, 3))`` on
    ``device``.

    A :class:`JointLocationTask` is the self-contained joint localizer and
    ``params`` is its state dict. A :class:`LocationTask` is the frozen
    localizer: ``params`` is the head's state dict and ``composite_params``
    the composite's RIR branch (a ``ConvolutionalVQVAE`` state dict). The
    radius is the range head's prediction when the task has one, else the
    config's fixed ``R``. Runs on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    if isinstance(task, LocationTask) and composite_params is None:
        raise ValueError("the frozen localizer needs composite_params (its RIR branch)")
    receiver = torch.tensor(config.receiver_position, dtype=torch.float32, device=device)
    room = torch.tensor(config.room_dimensions, dtype=torch.float32, device=device)
    model = _load(task.build_model, params, device)
    predicts_radius = bool(getattr(task, "predict_radius", False))

    if isinstance(task, JointLocationTask):

        def raw(spec):
            (x,) = task.model_inputs(spec)
            return model(x)[0]

    elif isinstance(task, LocationTask):
        rir = _load(task.build_rir_model, composite_params, device)

        def raw(spec):
            return model(task.encodings_from_composite(rir, spec))

    else:
        raise TypeError(f"no serving path for task {type(task).__name__}")

    @torch.inference_mode()
    def serve(spec) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        spec = torch.as_tensor(spec, dtype=torch.float32, device=device)
        with full_fp32():
            pred = raw(spec)
        theta = task.decode_angle(pred).reshape(-1)
        if predicts_radius:
            radius = task.decode_radius(pred).reshape(-1)
        else:
            radius = torch.full_like(theta, config.R)
        coords = source_coordinates(theta, receiver, room, radius, config.Z_LOC_SOURCE)
        return theta, radius, coords

    return serve
