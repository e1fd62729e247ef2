"""Carry dense weights, and Adam's moments, across from the reference's
flax/optax layout.

flax names a model's ``Dense`` layers ``Dense_0 … Dense_k`` in call order,
each ``{"kernel": (in, out), "bias": (out,)}``; the port's models keep their
``nn.Linear`` layers in ``layers`` in the same order, with ``weight`` (out,
in). Parameters and optax's ``ScaleByAdamState`` leaves (``mu``, ``nu``,
``count``) arrive as nested dicts of numpy arrays, so this module needs
neither JAX nor flax nor optax.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def dlrm_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's DLRM ``state_dict`` from the reference DLRM's ``params``."""
    names = sorted(params, key=lambda k: int(k.rsplit("_", 1)[1]))
    if names != [f"Dense_{i}" for i in range(len(names))]:
        raise ValueError(f"expected flax params Dense_0 … Dense_k, got {sorted(params)}")
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        kernel = np.asarray(params[name]["kernel"], dtype=np.float32)
        bias = np.asarray(params[name]["bias"], dtype=np.float32)
        out[f"layers.{i}.weight"] = torch.from_numpy(np.array(kernel.T))  # a writable copy
        out[f"layers.{i}.bias"] = torch.from_numpy(bias.copy())
    return out


def adam_state_from_optax(
    params: Sequence[torch.nn.Parameter], mu: Mapping, nu: Mapping, count
) -> Dict[torch.nn.Parameter, Dict[str, torch.Tensor]]:
    """``torch.optim.Adam`` state for ``params`` (a DLRM's parameters in
    ``model.parameters()`` order: layers.0.weight, layers.0.bias, …) from
    optax ``scale_by_adam``'s first and second moments (flax layout) and its
    step count. Load it with ``optimizer.state.update(...)``: the two
    optimizers then continue alike (optax's bias corrections use the same
    count as torch's ``step``)."""
    moments = [dlrm_state_dict_from_flax(m) for m in (mu, nu)]
    names = list(moments[0])
    if len(names) != len(params):
        raise ValueError(f"{len(names)} moment leaves for {len(params)} parameters")
    out = {}
    for p, name in zip(params, names):
        m, v = (mo[name] for mo in moments)
        if m.shape != p.shape:
            raise ValueError(f"{name}: moment shape {tuple(m.shape)} != parameter {tuple(p.shape)}")
        out[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": m.to(p.device),
            "exp_avg_sq": v.to(p.device),
        }
    return out


def seeded_flax_params_like(model: torch.nn.Module, seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Random parameters in the flax layout for the ``nn.Linear`` layers of
    ``model.layers``, from a numpy seed: LeCun-normal kernels and small
    normal biases (non-zero, so a check also covers the bias path)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, layer in enumerate(model.layers):
        a, b = layer.in_features, layer.out_features
        out[f"Dense_{i}"] = {
            "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "bias": (0.05 * rng.standard_normal(b)).astype(np.float32),
        }
    return out
