"""Learnable Laplace nodes s_k = sigma_k + j*omega_k and window bandwidth T.

* ``sigma_k = EPS_SIGMA + softplus(sigma_hat_k)`` — strictly positive decay.
* ``T = T_MIN + softplus(T_hat)`` — window bandwidth; the exponential window
  folds into the pole as ``sigma_eff = sigma + 1/T``.

The pole handed to the scan is ``lambda_k = exp(log_mag_k + i*theta_k)`` with
``(log_mag, theta) = (-sigma_eff*Delta, -omega*Delta)``, so ``|lambda| <= 1``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.utils import inv_softplus, softplus

EPS_SIGMA = 1e-4
T_MIN = 1.0


def init_nodes(generator: torch.Generator, num_heads: int, num_nodes: int, *,
               sigma_min: float = 1e-3, sigma_max: float = 1.0,
               omega_max: float = math.pi / 4, init_T: float = 32.0,
               dtype=torch.float32, device=None) -> dict:
    """Per-(head, node) Laplace parameters + per-head window bandwidth."""
    H, S = num_heads, num_nodes
    sig = np.geomspace(sigma_min, sigma_max, S)
    sigma_hat = np.array([inv_softplus(max(s - EPS_SIGMA, 1e-6)) for s in sig])
    sigma_hat = torch.as_tensor(sigma_hat, dtype=torch.float32, device=device)
    sigma_hat = sigma_hat.expand(H, S) + 0.01 * torch.randn(
        (H, S), generator=generator, device=device)
    omega = omega_max * torch.rand((H, S), generator=generator, device=device)
    T_hat = torch.full((H,), inv_softplus(max(init_T - T_MIN, 1e-6)),
                       device=device)
    u = torch.randn((2, H, S), generator=generator, device=device) / S
    return {k: v.to(dtype) for k, v in {
        "sigma_hat": sigma_hat, "omega": omega, "T_hat": T_hat,
        "u_re": u[0], "u_im": u[1]}.items()}


def node_poles(params: dict, delta: float = 1.0, fold_window: bool = True, *,
               learnable_sigma: bool = True, learnable_omega: bool = True,
               learnable_T: bool = True):
    """(log_mag, theta, sigma, T): log_mag/theta/sigma [H, S], T [H].

    A parameter whose ``learnable_*`` switch is off (the paper's Table-4
    ablations) is detached, so it gets no gradient."""
    sigma_hat, omega, T_hat = params["sigma_hat"], params["omega"], params["T_hat"]
    if not learnable_sigma:
        sigma_hat = sigma_hat.detach()
    if not learnable_omega:
        omega = omega.detach()
    if not learnable_T:
        T_hat = T_hat.detach()
    sigma = EPS_SIGMA + softplus(sigma_hat)
    T = T_MIN + softplus(T_hat)
    sigma_eff = sigma + (1.0 / T)[:, None] if fold_window else sigma
    log_mag = -sigma_eff * delta
    theta = -omega * delta
    return log_mag, theta, sigma, T


def half_lives(params: dict) -> torch.Tensor:
    """Interpretability: the learned token-relevance half-lives ln2/sigma_k
    [H, S], in tokens (sigma without the window's 1/T)."""
    _, _, sigma, _ = node_poles(params, fold_window=False)
    return math.log(2.0) / sigma


def hann_window(t: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Symmetric Hann taper w(t;T) = 0.5*(1+cos(pi t / T)) for |t| <= T, zero
    outside; T is clamped at 1e-6."""
    inside = (t.abs() <= T).to(t.dtype)
    return 0.5 * (1.0 + torch.cos(math.pi * t / torch.clamp(T, min=1e-6))) * inside


def exponential_window(t: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """w(t;T) = exp(-|t|/T), the streaming-exact window; T is clamped at
    1e-6."""
    return torch.exp(-t.abs() / torch.clamp(T, min=1e-6))
