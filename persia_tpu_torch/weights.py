"""Carry dense weights, and Adam's moments, across from the reference's
flax/optax layout; the hybrid tier's dense ``TrainState`` as the bytes
``flax.serialization.to_bytes`` writes for the reference's; and the fused
tier's whole state, both ways.

flax names a model's ``Dense`` layers ``Dense_0 … Dense_k`` in call order,
each ``{"kernel": (in, out), "bias": (out,)}``; the port's models keep their
``nn.Linear`` layers in ``layers`` in the same order, with ``weight`` (out,
in). Parameters and optax's ``ScaleByAdamState`` leaves (``mu``, ``nu``,
``count``) arrive as nested dicts of numpy arrays, so this module needs
neither JAX nor flax nor optax.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.serialization import msgpack_restore, msgpack_serialize


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


def dlrm_state_dict_to_flax(model: torch.nn.Module, tensor_of=lambda p: p) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of ``dlrm_state_dict_from_flax``: ``{"Dense_i": {"bias",
    "kernel" (in, out)}}`` as host arrays, with the names and leaves in
    sorted order (the order of a state the reference's step returned).
    ``tensor_of`` maps each parameter to the tensor to take (an Adam
    moment of it, say)."""
    layers = model.layers
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name in sorted(f"Dense_{i}" for i in range(len(layers))):
        layer = layers[int(name.rsplit("_", 1)[1])]
        out[name] = {"bias": _host_array(tensor_of(layer.bias)),
                     "kernel": np.ascontiguousarray(_host_array(tensor_of(layer.weight)).T)}
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


def _adam_of(state):
    opt = state.optimizer
    if not isinstance(opt, torch.optim.Adam) or any(g.get("amsgrad") for g in opt.param_groups):
        raise ValueError(f"the dense state maps to optax's adam: expected torch.optim.Adam, got {opt!r}")
    return opt


def _scalar_state_dtype() -> torch.dtype:
    """The dtype ``torch.optim.Adam`` gives a new ``step`` tensor."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def train_state_to_flax_bytes(state) -> bytes:
    """The port's hybrid ``TrainState`` (a DLRM, ``torch.optim.Adam``) as the
    bytes ``flax.serialization.to_bytes`` writes for the reference's
    ``TrainState`` carrying the same arrays: ``params`` (kernels (in,
    out)), ``batch_stats`` ``{}``, ``opt_state`` as ``optax.adam``'s chain
    (``count``, ``mu``, ``nu``; then the learning-rate scale's empty state),
    ``step`` and ``loss_scale`` (``None``, or ``scale`` and
    ``good_steps``). Before Adam's first step its moments are zeros and its
    count 0."""
    model, opt = state.model, _adam_of(state)
    first = next(iter(model.parameters()))
    count = int(float(opt.state[first]["step"])) if opt.state.get(first) else 0

    def moment(key):
        return lambda p: opt.state[p][key] if opt.state.get(p) else torch.zeros_like(p)

    ls = state.loss_scale
    tree = {
        "params": dlrm_state_dict_to_flax(model),
        "batch_stats": {},
        "opt_state": {"0": {"count": np.asarray(count, np.int32),
                            "mu": dlrm_state_dict_to_flax(model, moment("exp_avg")),
                            "nu": dlrm_state_dict_to_flax(model, moment("exp_avg_sq"))},
                      "1": {}},
        "step": np.asarray(state.step, np.int32),
        "loss_scale": None if ls is None else {"scale": np.asarray(ls.scale, np.float32),
                                               "good_steps": np.asarray(ls.good_steps, np.int32)},
    }
    return msgpack_serialize(tree)


def train_state_from_flax_bytes(state, raw: bytes):
    """Load the bytes of a reference ``TrainState`` (or of
    ``train_state_to_flax_bytes``) into ``state`` in place: the model's
    parameters, Adam's moments and ``step`` tensors (those that exist are
    overwritten, so a captured or cached step stays valid; missing ones are
    made as Adam makes them), the step and the loss scale. Returns
    ``state``."""
    tree = msgpack_restore(raw)
    model, opt = state.model, _adam_of(state)
    adam = tree["opt_state"]["0"]
    layers = model.layers
    if sorted(tree["params"]) != sorted(f"Dense_{i}" for i in range(len(layers))):
        raise ValueError(f"the bytes hold layers {sorted(tree['params'])}, the model {len(layers)}")
    if (tree["loss_scale"] is None) != (state.loss_scale is None):
        raise ValueError("the bytes and the state disagree on a dynamic loss scale")
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    count = float(np.asarray(adam["count"]))
    with torch.no_grad():
        for name, leaves in tree["params"].items():
            layer = layers[int(name.rsplit("_", 1)[1])]
            for p, key, t in ((layer.weight, "kernel", True), (layer.bias, "bias", False)):
                host = [leaves[key], adam["mu"][name][key], adam["nu"][name][key]]
                host = [_host_tensor(a.T if t else a).to(p.device) for a in host]
                if host[0].shape != p.shape or host[0].dtype != p.dtype:
                    raise ValueError(f"{name}.{key}: {host[0].dtype} {tuple(host[0].shape)} in the bytes, "
                                     f"{p.dtype} {tuple(p.shape)} in the model")
                p.copy_(host[0])
                st = opt.state[p]
                if not st:
                    g = groups[id(p)]
                    on_device = g.get("capturable") or g.get("fused")
                    st["step"] = torch.zeros((), dtype=torch.float32 if g.get("fused") else _scalar_state_dtype(),
                                             device=p.device if on_device else "cpu")
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["step"].fill_(count)
                st["exp_avg"].copy_(host[1])
                st["exp_avg_sq"].copy_(host[2])
    state.step = int(np.asarray(tree["step"]))
    if state.loss_scale is not None:
        state.loss_scale.scale = float(np.asarray(tree["loss_scale"]["scale"], np.float32))
        state.loss_scale.good_steps = int(np.asarray(tree["loss_scale"]["good_steps"]))
    return state


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


# ---------------------------------------------------------------------------
# The fused tier's whole state (``persia_tpu/parallel/fused_ctx.py``'s
# checkpoint): every leaf of the reference's ``FusedTrainState`` for a DLRM
# trained with ``optax.adam``, keyed by its ``jax.tree_util.keystr`` path,
# in the reference's leaf order (dict keys sorted).

_PATH_KEYS = re.compile(r"\['([^']*)'\]")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as its raw 16-bit words in a 2-byte void
    dtype (numpy has no bf16)."""
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()  # never a view of the live state
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _fused_leaves(state) -> List[Tuple[str, Callable[[], np.ndarray]]]:
    """(path, array getter) of every leaf, in the reference's order."""
    layers = state.model.layers
    names = sorted(f"Dense_{i}" for i in range(len(layers)))
    opt = state.optimizer.state
    out: List[Tuple[str, Callable[[], np.ndarray]]] = []

    def dense(prefix, get):
        for name in names:
            layer = layers[int(name.rsplit("_", 1)[1])]
            out.append((f"{prefix}['{name}']['bias']", lambda l=layer: _host_array(get(l.bias))))
            out.append((f"{prefix}['{name}']['kernel']", lambda l=layer: _host_array(get(l.weight).T)))

    dense(".params", lambda p: p)
    first = layers[0].weight
    out.append((".opt_state[0].count",
                lambda: np.asarray(int(float(opt[first]["step"])) if opt.get(first) else 0, np.int32)))
    dense(".opt_state[0].mu", lambda p: opt[p]["exp_avg"])
    dense(".opt_state[0].nu", lambda p: opt[p]["exp_avg_sq"])
    for name in sorted(state.tables):
        out.append((f".tables['{name}']", lambda t=state.tables[name]: _host_array(t)))
    for name in sorted(state.emb_state):
        for k in sorted(state.emb_state[name]):
            out.append((f".emb_state['{name}']['{k}']", lambda t=state.emb_state[name][k]: _host_array(t)))
    out.append((".emb_batch_state", lambda: _host_array(state.emb_batch_state)))
    out.append((".step", lambda: _host_array(state.step.to(torch.int32)).reshape(())))
    return out


def fused_state_manifest(state) -> List[str]:
    """The leaf paths of ``state`` as the reference names them."""
    return [path for path, _ in _fused_leaves(state)]


def fused_state_to_flax(state) -> Tuple[List[str], List[np.ndarray]]:
    """(paths, arrays): the port's ``FusedTrainState`` as the reference's
    leaves (flax kernels (in, out), optax's Adam moments and count)."""
    leaves = _fused_leaves(state)
    return [p for p, _ in leaves], [get() for _, get in leaves]


def fused_state_from_flax(manifest: Sequence[str], arrays: Sequence[np.ndarray], model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, device=None, into=None):
    """The port's ``FusedTrainState`` from the reference's leaves (numpy
    arrays in ``manifest``'s order): ``model``'s parameters and
    ``optimizer``'s (an Adam over them) state are loaded in place, the
    tables and their state made on ``device`` (``cuda`` unless given).
    With ``into``, a state of the same layout, its tables, their state, the
    powers and the step are instead overwritten in place from the host
    arrays (no second copy on the device), and ``into`` returned."""
    from persia_tpu_torch.device import resolve_device
    from persia_tpu_torch.parallel.fused_step import FusedTrainState, prepare_dense_optimizer

    if len(manifest) != len(arrays):
        raise ValueError(f"{len(manifest)} paths for {len(arrays)} arrays")
    dev = resolve_device(device)
    params: Dict = {}
    moments: Dict[str, Dict] = {"mu": {}, "nu": {}}
    tables, emb_state = {}, {}
    count = batch_state = step = None

    def put(a, live):
        if live is None:
            return _host_tensor(a).to(dev)
        return live.copy_(_host_tensor(a).view(live.shape))

    for path, a in zip(manifest, arrays):
        keys = _PATH_KEYS.findall(path)
        if path.startswith(".params["):
            params.setdefault(keys[0], {})[keys[1]] = a
        elif path == ".opt_state[0].count":
            count = a
        elif path.startswith((".opt_state[0].mu[", ".opt_state[0].nu[")):
            moments[path[14:16]].setdefault(keys[0], {})[keys[1]] = a
        elif path.startswith(".tables["):
            tables[keys[0]] = put(a, into and into.tables[keys[0]])
        elif path.startswith(".emb_state["):
            emb_state.setdefault(keys[0], {})[keys[1]] = put(a, into and into.emb_state[keys[0]][keys[1]])
        elif path == ".emb_batch_state":
            batch_state = put(np.asarray(a, np.float32), into and into.emb_batch_state)
        elif path == ".step":
            step = put(np.asarray(a, np.int32).reshape(()), into and into.step)
        else:
            raise ValueError(f"unknown fused-state leaf {path!r}")
    if count is None or batch_state is None or step is None:
        raise ValueError("the fused state lacks the Adam count, the batch powers or the step")
    model.load_state_dict(dlrm_state_dict_from_flax(params))
    model.to(dev)
    prepare_dense_optimizer(optimizer, dev)
    params_list = list(model.parameters())
    for p, st in adam_state_from_optax(params_list, moments["mu"], moments["nu"], count).items():
        for k, v in st.items():
            optimizer.state[p][k].copy_(v)
    if into is not None:
        return into
    for name in tables:
        emb_state.setdefault(name, {})
    return FusedTrainState(model=model, optimizer=optimizer, tables=tables, emb_state=emb_state,
                           emb_batch_state=batch_state, step=step)
