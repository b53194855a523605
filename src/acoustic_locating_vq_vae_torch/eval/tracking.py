"""Moving-source tracking: trajectory helpers, circular-state smoothing and
track metrics.

Counterpart of ``acoustic_locating_vq_vae_tpu/eval/tracking.py:33-136``,
copied: host numpy that shapes the inputs of synthesis and digests the
localizer's outputs, the same numbers on the same inputs (``walk_trajectory``
draws from ``np.random.default_rng(seed)`` as JAX's does). The trained
localizer becomes a tracker by synthesizing a piecewise-static trajectory
(the source holds a position for one utterance window, the model's fixed
500-frame geometry, then moves), localizing every window in one batch and
smoothing the angle track with a constant-velocity alpha-beta filter on the
unwrapped angle. Driven by ``cli/track.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "arc_trajectory",
    "walk_trajectory",
    "alpha_beta_filter",
    "wrap_angle",
    "track_metrics",
]


def wrap_angle(a: np.ndarray) -> np.ndarray:
    """Wrap to (-pi, pi]."""
    return np.angle(np.exp(1j * np.asarray(a, np.float64))).astype(np.float32)


def arc_trajectory(
    n: int,
    theta_start: float,
    theta_end: float,
    radius_start: float = 1.0,
    radius_end: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Constant-rate arc: n window positions with theta swept linearly from
    ``theta_start`` to ``theta_end`` (NOT wrapped before synthesis input —
    the synthesizer's geometry is 2pi-periodic, so values beyond ±pi are
    fine and keep the true track unwrapped for filtering) and radius swept
    linearly (a spiral when the ends differ)."""
    if n < 1:
        raise ValueError(f"need at least one window, got n={n}")
    theta = np.linspace(theta_start, theta_end, n).astype(np.float32)
    r_end = radius_start if radius_end is None else radius_end
    radius = np.linspace(radius_start, r_end, n).astype(np.float32)
    return theta, radius


def walk_trajectory(
    n: int,
    seed: int = 0,
    theta_step: float = 0.15,
    radius: float = 1.0,
    radius_step: float = 0.0,
    radius_bounds: Tuple[float, float] = (0.5, 1.5),
) -> Tuple[np.ndarray, np.ndarray]:
    """Random walk: theta accumulates N(0, theta_step²) increments from a
    uniform start; radius (optionally) accumulates clipped N(0, radius_step²)
    increments inside ``radius_bounds``."""
    rng = np.random.default_rng(seed)
    theta0 = rng.uniform(-np.pi, np.pi)
    theta = theta0 + np.concatenate(
        [[0.0], np.cumsum(rng.normal(0.0, theta_step, n - 1))]
    )
    r = np.full(n, float(radius))
    if radius_step > 0:
        steps = rng.normal(0.0, radius_step, n - 1)
        for i in range(1, n):
            r[i] = np.clip(r[i - 1] + steps[i - 1], *radius_bounds)
    return theta.astype(np.float32), r.astype(np.float32)


def alpha_beta_filter(
    obs: np.ndarray, alpha: float = 0.5, beta: float = 0.1
) -> np.ndarray:
    """Constant-velocity alpha-beta tracker over a circular observation
    sequence.

    The classic two-state (position, rate) fixed-gain filter, run on
    per-step UNWRAPPED innovations: each observation is compared to the
    prediction modulo 2pi, so the track follows a source through the ±pi
    seam without a 2pi glitch. With window-to-window motion roughly
    constant-rate (the arc trajectories here) the filter averages
    measurement noise without the lag a plain EMA pays on a moving target.
    Returns the filtered positions wrapped to (-pi, pi].
    """
    obs = np.asarray(obs, np.float64)
    if obs.ndim != 1 or len(obs) == 0:
        raise ValueError(f"need a 1-D observation sequence, got shape {obs.shape}")
    if not (0.0 < alpha <= 1.0) or not (0.0 <= beta <= 2.0):
        raise ValueError(f"unstable gains alpha={alpha}, beta={beta}")
    x, v = obs[0], 0.0
    out = np.empty_like(obs)
    out[0] = x
    for k in range(1, len(obs)):
        x_pred = x + v
        innov = np.angle(np.exp(1j * (obs[k] - x_pred)))  # circular residual
        x = x_pred + alpha * innov
        v = v + beta * innov
        out[k] = x
    return wrap_angle(out)


def track_metrics(
    theta_true: np.ndarray,
    theta_pred: np.ndarray,
    theta_smoothed: Optional[np.ndarray] = None,
    radius_true: Optional[np.ndarray] = None,
    radius_pred: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Angular (and, with a range head, radial) track accuracy. Angles are
    compared on the circle; all values float for JSON."""
    err = np.angle(np.exp(1j * (np.asarray(theta_pred) - np.asarray(theta_true))))
    out = {
        "rmse_radians": float(np.sqrt(np.mean(err**2))),
        "median_abs_radians": float(np.median(np.abs(err))),
        "max_abs_radians": float(np.max(np.abs(err))),
    }
    if theta_smoothed is not None:
        s_err = np.angle(
            np.exp(1j * (np.asarray(theta_smoothed) - np.asarray(theta_true)))
        )
        out["rmse_smoothed_radians"] = float(np.sqrt(np.mean(s_err**2)))
    if radius_pred is not None and radius_true is not None:
        r_err = np.asarray(radius_pred, np.float64) - np.asarray(radius_true, np.float64)
        out["rmse_radius_m"] = float(np.sqrt(np.mean(r_err**2)))
    return out
