"""The localizer's serving closure and its exported artifact: echoed power
spectrogram (or raw waveform) in, (angle, source radius, 3-D coordinates)
out.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/serving.py:45-248``.
Weights enter as the port's state dicts (see ``eval/weights.py:
params_from_jax``). A task with ``compute_dtype="bfloat16"`` serves its RIR
branch's convs in bf16, as JAX's closure does through ``task.build_model()``
(JAX ``serving.py:112``); the VQ assignment and the head stay full float32
(``full_fp32``).

``export_localizer`` writes the closure as one ``torch.export`` program
(``localizer.pt2``, weights embedded, batch dimension symbolic unless
pinned) beside a ``serving.json`` sidecar with the JAX package's keys.
``load_localizer`` restores a callable from the directory alone: it needs
``torch`` and the module that registers the VQ assignment's operator
(``ops/vq.py``), not the model classes, the tasks or the store. Two things
the program does not carry are put back by the loader, because a loaded
artifact called bare would get them wrong silently:

* the kernel: the graph holds the registered operator
  ``acoustic_locating_vq_vae_torch::vq_nearest``, which dispatches to the
  ``csrc/vq_nearest.cu`` kernel on the card (never ``argmin``), so loading
  imports its registration first;
* the precision: TF32 in cuDNN is Python state, on by default, and not a
  node of the graph; TF32 convolutions flip near-tie codes (the JAX
  package's ops/vq.py:57-60), so ``call`` runs under :func:`full_fp32`.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data.config import DatasetConfig
from ..data.synth import observed_power_spec
from ..dsp.specs import source_coordinates
from ..train.tasks import JointLocationTask, LocationTask
from ..utils.device import full_fp32, resolve_device

__all__ = [
    "SERVING_BLOB", "SERVING_META", "export_localizer", "full_fp32", "load_localizer", "make_serving_fn",
    "params_fingerprint", "resolve_device", "store_provenance", "update_sidecar",
]

SERVING_BLOB = "localizer.pt2"
SERVING_META = "serving.json"
# the one module a loaded artifact needs besides torch: it registers the VQ assignment's operator
OP_MODULE = "acoustic_locating_vq_vae_torch.ops.vq"

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
    from_audio: bool = False,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Build ``serve(x)`` -> ``(theta_rad (B,), radius_m (B,), coords_m
    (B, 3))`` on ``device``: ``x`` is an echoed power spectrogram ``(B,
    num_freq, num_frames)``, or with ``from_audio`` the raw echoed waveform
    ``(B, config.audio_samples)``, whose spectrogram comes from
    :func:`..data.synth.observed_power_spec`, the function ``synthesize_batch``
    builds its spectrogram fields from.

    A :class:`JointLocationTask` is the self-contained joint localizer and
    ``params`` is its state dict. A :class:`LocationTask` is the frozen
    localizer: ``params`` is the head's state dict and ``composite_params``
    the composite's RIR branch (a ``ConvolutionalVQVAE`` state dict). The
    radius is the range head's prediction when the task has one, else the
    config's fixed ``R``. Runs on the card unless ``device="cpu"``.

    ``serve.localize`` is the same computation without the input conversion,
    the inference mode and the precision setting: the function that
    :func:`export_localizer` traces. ``serve.modules`` holds the models
    whose weights it reads, ``serve.device`` and ``serve.predicts_radius``
    what they say, ``serve.from_audio`` the input it takes."""
    device = resolve_device(device)
    if isinstance(task, LocationTask) and composite_params is None:
        raise ValueError("the frozen localizer needs composite_params (its RIR branch)")
    receiver = torch.tensor(config.receiver_position, dtype=torch.float32, device=device)
    room = torch.tensor(config.room_dimensions, dtype=torch.float32, device=device)
    model = _load(task.build_model, params, device)
    predicts_radius = bool(getattr(task, "predict_radius", False))

    if isinstance(task, JointLocationTask):
        modules = (model,)

        def raw(spec):
            (x,) = task.model_inputs(spec)
            return model(x)[0]

    elif isinstance(task, LocationTask):
        rir = _load(task.build_rir_model, composite_params, device)
        modules = (model, rir)

        def raw(spec):
            return model(task.encodings_from_composite(rir, spec))

    else:
        raise TypeError(f"no serving path for task {type(task).__name__}")

    def localize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # THE shared frontend: synthesize_batch builds echoed_spec from the same function
        spec = observed_power_spec(x, config) if from_audio else x
        pred = raw(spec)
        theta = task.decode_angle(pred).reshape(-1)
        if predicts_radius:
            radius = task.decode_radius(pred).reshape(-1)
        else:
            radius = torch.full_like(theta, config.R)
        coords = source_coordinates(theta, receiver, room, radius, config.Z_LOC_SOURCE)
        return theta, radius, coords

    @torch.inference_mode()
    def serve(x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with full_fp32():
            return localize(x)

    serve.localize = localize
    serve.modules = modules
    serve.device = device
    serve.predicts_radius = predicts_radius
    serve.from_audio = from_audio
    return serve


def params_fingerprint(state_dict: StateDict) -> str:
    """sha256 over a state dict: every entry's key, shape, dtype and raw
    bytes, in sorted key order, so two artifacts carry the same fingerprint
    if and only if they embed bit-identical weights under the same names
    (JAX ``serving.py:45-63``, over state-dict keys instead of flax paths;
    the two packages' digests of the same weights differ)."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        t = torch.as_tensor(state_dict[key]).detach().cpu().contiguous()
        h.update(key.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def store_provenance(store, stage: str, params: StateDict, task=None) -> dict:
    """The training provenance of an artifact: the store's path, the stage's
    name and manifest entry (step, save sequence, task metadata), the
    exported weights' fingerprint and, given the task, the evaluation modes
    resolved at export time (JAX ``serving.py:66-88``)."""
    entry = dict(store.stages().get(stage, {}))
    entry.pop("path", None)  # host-local detail; the store root covers it
    prov = {
        "store": os.path.abspath(store.root),
        "stage": stage,
        "stage_manifest": entry,
        "params_sha256": params_fingerprint(params),
    }
    if task is not None:
        prov["task_modes"] = {
            k: getattr(task, k)
            for k in ("compat_vq_flatten", "input_mode", "target_mode", "predict_radius")
            if hasattr(task, k)
        }
    return prov


class _Localizer(torch.nn.Module):
    """The module ``torch.export`` traces: the serving models as submodules,
    so that their weights are the program's parameters, and ``localize`` as
    the forward."""

    def __init__(self, serve):
        super().__init__()
        self.models = torch.nn.ModuleList(serve.modules)
        self.localize = serve.localize

    def forward(self, x: torch.Tensor):
        return self.localize(x)


def export_localizer(
    task: Union[JointLocationTask, LocationTask],
    params: StateDict,
    config: DatasetConfig,
    out_dir: str,
    composite_params: Optional[StateDict] = None,
    batch_size: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    serve_fn=None,
    from_audio: bool = False,
    provenance: Optional[dict] = None,
) -> dict:
    """Write the localizer's inference program to ``out_dir`` as
    ``localizer.pt2`` (``torch.export``, weights embedded on ``device``) and
    a ``serving.json`` sidecar; returns the sidecar dict (JAX
    ``serving.py:155-223``).

    ``batch_size=None`` exports a symbolic batch dimension, so one artifact
    serves any batch size; an int pins it. ``serve_fn``: a closure of
    :func:`make_serving_fn` to export instead of building one (its own
    device and input then hold), so that a caller comparing the artifact
    with the live closure compares with the very object exported."""
    if serve_fn is None:
        serve_fn = make_serving_fn(task, params, config, composite_params, device=device, from_audio=from_audio)
    from_audio = serve_fn.from_audio
    b = 2 if batch_size is None else int(batch_size)  # a symbolic batch needs an example other than 1
    in_shape = (config.audio_samples,) if from_audio else (config.num_freq, config.num_frames)
    example = torch.zeros((b, *in_shape), dtype=torch.float32, device=serve_fn.device)
    dynamic = ({0: torch.export.Dim("b")},) if batch_size is None else None
    with torch.no_grad(), full_fp32():
        program = torch.export.export(_Localizer(serve_fn), (example,), dynamic_shapes=dynamic, strict=False)

    os.makedirs(out_dir, exist_ok=True)
    blob = os.path.join(out_dir, SERVING_BLOB)
    torch.export.save(program, blob)
    meta = {
        "input": {
            "name": "echoed_waveform" if from_audio else "echoed_power_spectrogram",
            "shape": ["b" if batch_size is None else int(batch_size)] + [int(d) for d in in_shape],
            "dtype": "float32",
        },
        "outputs": ["theta_rad", "radius_m", "coords_m"],
        "model": "joint" if isinstance(task, JointLocationTask) else "frozen",
        "predicts_radius": serve_fn.predicts_radius,
        "platforms": [serve_fn.device.type],
        "bytes": os.path.getsize(blob),
        "geometry": config.to_reference_dict(),
    }
    if provenance:
        meta["provenance"] = provenance
    with open(os.path.join(out_dir, SERVING_META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def update_sidecar(path: str, **fields) -> dict:
    """Merge post-export fields (the reload-and-compare summary, a latency
    bench) into an artifact's ``serving.json`` (JAX ``serving.py:226-237``)."""
    sidecar = os.path.join(path, SERVING_META)
    with open(sidecar) as f:
        meta = json.load(f)
    meta.update(fields)
    with open(sidecar, "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_localizer(path: str, device: Union[str, torch.device, None] = None) -> Tuple[Callable, dict]:
    """Restore ``(call, meta)`` from an :func:`export_localizer` directory.

    The program's weights lie on the device type it was exported on
    (``meta["platforms"]``); ``device`` (default: that type) must be of that
    type, and a host without it raises before anything is read. ``call(x)``
    runs the program under ``torch.inference_mode()`` and :func:`full_fp32`;
    a pinned artifact raises on another batch size."""
    with open(os.path.join(path, SERVING_META)) as f:
        meta = json.load(f)
    (platform,) = meta["platforms"]
    device = torch.device(platform if device is None else device)
    if device.type != platform:
        raise ValueError(
            f"the artifact in {path!r} was exported on {platform!r} and its weights live there; "
            f"it cannot run on {device}: export it again with --device {device.type}"
        )
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the artifact in {path!r} was exported on 'cuda' and its weights live there, "
            "but this host has no CUDA card (torch.cuda.is_available() is False)"
        )
    importlib.import_module(OP_MODULE)  # registers the operator the graph calls
    module = torch.export.load(os.path.join(path, SERVING_BLOB)).module()

    def call(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.inference_mode(), full_fp32():
            return module(x)

    call.module = module
    return call, meta
