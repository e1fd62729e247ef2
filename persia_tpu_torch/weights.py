"""Carry dense weights, and Adam's moments, across from the reference's
flax/optax layout; the hybrid tier's dense ``TrainState`` and the cache
tier's ``CachedTrainState`` as the bytes ``flax.serialization.to_bytes``
writes for the reference's; and the fused tier's whole state, both ways.

flax names a model's parameters by module path: a ``Dense`` layer is
``{"kernel": (in, out), "bias": (out,)}`` under its name (``Dense_0 …
Dense_k`` in call order where unnamed, ``att_0/Dense_1`` inside a
submodule). Each of the port's models lists its ``nn.Linear`` layers,
its batch norms (``models.layers.BatchNorm``: ``scale`` and ``bias`` under
``params``, ``mean`` and ``var`` under ``batch_stats``) and bare parameters
under those paths in ``flax_modules()``; a torch ``weight`` is (out, in),
the transpose of flax's kernel. Parameters, batch statistics and optax's
``ScaleByAdamState`` leaves (``mu``, ``nu``, ``count``) arrive as nested
dicts of numpy arrays, so this module needs neither JAX nor flax nor
optax.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from persia_tpu_torch.models.layers import BatchNorm
from persia_tpu_torch.serialization import msgpack_restore, msgpack_serialize

Path = Tuple[str, ...]


def flax_leaves(model: torch.nn.Module) -> List[Tuple[Path, torch.nn.Parameter, bool]]:
    """(flax path, parameter, transposed) of each of ``model``'s
    parameters, in call order: a layer's kernel (transposed) before its
    bias, a batch norm's scale before its bias."""
    out = []
    for path, m in model.flax_modules():
        if isinstance(m, torch.nn.Linear):
            out.append((path + ("kernel",), m.weight, True))
            if m.bias is not None:
                out.append((path + ("bias",), m.bias, False))
        elif isinstance(m, BatchNorm):
            out += [(path + ("scale",), m.scale, False), (path + ("bias",), m.bias, False)]
        else:
            out.append((path, m, False))
    return out


def stats_leaves(model: torch.nn.Module) -> List[Tuple[Path, torch.Tensor]]:
    """(flax path, buffer) of each of ``model``'s batch statistics (flax's
    ``batch_stats``): each batch norm's ``mean`` and ``var``; none for a
    model without batch norms."""
    out = []
    for path, m in model.flax_modules():
        if isinstance(m, BatchNorm):
            out += [(path + ("mean",), m.mean), (path + ("var",), m.var)]
    return out


def _nest(leaves) -> Dict:
    """Nested dicts from (path, value) pairs, every level's names sorted
    (the order of a tree flax serialises)."""
    out: Dict = {}
    for path, value in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def ordered(tree):
        return {k: ordered(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}

    return ordered(out)


def batch_stats_to_flax(model: torch.nn.Module) -> Dict:
    """``model``'s batch statistics as flax's ``batch_stats`` tree of host
    f32 arrays (``{}`` for a model without batch norms)."""
    return _nest((path, _host_array(t)) for path, t in stats_leaves(model))


def _check_stats(model: torch.nn.Module, batch_stats: Mapping) -> List[Tuple[Path, torch.Tensor]]:
    leaves = stats_leaves(model)
    if sorted(_flat_paths(batch_stats)) != sorted(path for path, _ in leaves):
        raise ValueError(f"batch_stats holds {sorted('/'.join(p) for p in _flat_paths(batch_stats))}, the model "
                         f"{sorted('/'.join(p) for p, _ in leaves)}")
    return leaves


def batch_stats_from_flax(model: torch.nn.Module, batch_stats: Mapping) -> None:
    """Load flax's ``batch_stats`` tree into ``model``'s batch statistics,
    in place; the tree must hold exactly the model's paths."""
    with torch.no_grad():
        for path, t in _check_stats(model, batch_stats):
            a = _host_tensor(_at(batch_stats, path))
            if a.shape != t.shape or a.dtype != t.dtype:
                raise ValueError(f"{'/'.join(path)}: {a.dtype} {tuple(a.shape)} in the tree, "
                                 f"{t.dtype} {tuple(t.shape)} in the model")
            t.copy_(a.to(t.device))


def _flat_paths(tree: Mapping, prefix: Path = ()) -> List[Path]:
    out = []
    for k, v in tree.items():
        out.extend(_flat_paths(v, prefix + (k,)) if isinstance(v, Mapping) else [prefix + (k,)])
    return out


def _at(tree: Mapping, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _check_paths(model: torch.nn.Module, tree: Mapping, what: str) -> List[Tuple[Path, torch.nn.Parameter, bool]]:
    leaves = flax_leaves(model)
    if sorted(_flat_paths(tree)) != sorted(path for path, _, _ in leaves):
        raise ValueError(f"{what} holds {sorted('/'.join(p) for p in _flat_paths(tree))}, the model "
                         f"{sorted('/'.join(p) for p, _, _ in leaves)}")
    return leaves


def state_dict_from_flax(model: torch.nn.Module, params: Mapping,
                         batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` from the reference model's ``params`` and,
    for a model with batch norms, its ``batch_stats`` (where not given, the
    model's own statistics, copied)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out: Dict[str, torch.Tensor] = {}
    for path, p, transposed in _check_paths(model, params, "params"):
        a = np.asarray(_at(params, path), dtype=np.float32)
        out[names[id(p)]] = torch.from_numpy(np.array(a.T if transposed else a))  # a writable copy
    buffers = {id(b): n for n, b in model.named_buffers()}
    leaves = stats_leaves(model) if batch_stats is None else _check_stats(model, batch_stats)
    for path, t in leaves:
        out[buffers[id(t)]] = (t.detach().cpu().clone() if batch_stats is None
                               else torch.from_numpy(np.array(_at(batch_stats, path), dtype=np.float32)))
    return out


def state_dict_to_flax(model: torch.nn.Module, tensor_of=lambda p: p) -> Dict:
    """The inverse of ``state_dict_from_flax``: flax's nested params as
    host arrays, the names at every level in sorted order (the order of a
    state the reference's step returned). ``tensor_of`` maps each parameter
    to the tensor to take (an Adam moment of it, say)."""
    leaves = []
    for path, p, transposed in flax_leaves(model):
        a = _host_array(tensor_of(p))
        leaves.append((path, np.ascontiguousarray(a.T) if transposed else a))
    return _nest(leaves)


def adam_state_from_optax(
    model: torch.nn.Module, mu: Mapping, nu: Mapping, count
) -> Dict[torch.nn.Parameter, Dict[str, torch.Tensor]]:
    """``torch.optim.Adam`` state for ``model``'s parameters from optax
    ``scale_by_adam``'s first and second moments (flax layout) and its step
    count. Load it with ``optimizer.state.update(...)``: the two optimizers
    then continue alike (optax's bias corrections use the same count as
    torch's ``step``)."""
    moments = [state_dict_from_flax(model, m) for m in (mu, nu)]
    out = {}
    for name, p in model.named_parameters():
        m, v = moments[0][name], moments[1][name]
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"{name}: moment shapes {tuple(m.shape)}, {tuple(v.shape)} != parameter "
                             f"{tuple(p.shape)}")
        out[p] = {"step": torch.tensor(float(np.asarray(count))), "exp_avg": m.to(p.device),
                  "exp_avg_sq": v.to(p.device)}
    return out


def cached_dense_from_flax(state, params: Mapping, mu: Mapping, nu: Mapping, count,
                           batch_stats: Optional[Mapping] = None) -> None:
    """Carry the reference's ``CachedTrainState`` dense leaves into the
    port's (``persia_tpu_torch.embedding.hbm_cache.CachedTrainState``), in
    place: ``params`` (and ``batch_stats``, where given) into the model,
    ``optax.adam``'s ``mu``, ``nu`` and ``count`` into its
    ``torch.optim.Adam``. The tables need no carrying: both tiers start
    them from zeros and fill them from the servers' rows, seeded by sign.
    ``cached_state_to_flax_bytes`` / ``cached_state_from_flax_bytes`` carry
    the whole state."""
    model = state.model
    model.load_state_dict(state_dict_from_flax(model, params, batch_stats))
    opt_state = state.optimizer.state
    for p, st in adam_state_from_optax(model, mu, nu, count).items():
        live = opt_state[p]
        for k, v in st.items():
            if k in live:
                live[k].copy_(v)
            else:
                live[k] = v.to(p.device)


def _adam_of(state):
    opt = state.optimizer
    if not isinstance(opt, torch.optim.Adam) or any(g.get("amsgrad") for g in opt.param_groups):
        raise ValueError(f"the dense state maps to optax's adam: expected torch.optim.Adam, got {opt!r}")
    return opt


def _scalar_state_dtype() -> torch.dtype:
    """The dtype ``torch.optim.Adam`` gives a new ``step`` tensor."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def _dense_tree(state) -> Dict:
    """A state's dense leaves as flax's trees: ``params`` (kernels (in,
    out)), ``batch_stats`` (``{}`` for a model without batch norms) and
    ``opt_state``, ``optax.adam``'s chain (``count``, ``mu``, ``nu``; then
    the learning-rate scale's empty state). Before Adam's first step its
    moments are zeros and its count 0. Under a ring or sharded dense sync
    (``state.sync``) ``opt_state`` is the reference's ``{"opt", "ef"}``
    wrapper (``SyncState.opt_state_tree``; a collective at more than one
    rank)."""
    model, opt = state.model, _adam_of(state)
    first = next(iter(model.parameters()))
    count = int(float(opt.state[first]["step"])) if opt.state.get(first) else 0

    def moment(key):
        return lambda p: opt.state[p][key] if opt.state.get(p) else torch.zeros_like(p)

    opt_state = {"0": {"count": np.asarray(count, np.int32),
                       "mu": state_dict_to_flax(model, moment("exp_avg")),
                       "nu": state_dict_to_flax(model, moment("exp_avg_sq"))},
                 "1": {}}
    sync = getattr(state, "sync", None)
    if sync is not None and sync.wrapped:  # the dense sync's {"opt", "ef"} wrapper
        opt_state = sync.opt_state_tree(opt_state)
    return {
        "params": state_dict_to_flax(model),
        "batch_stats": batch_stats_to_flax(model),
        "opt_state": opt_state,
    }


def train_state_to_flax_bytes(state) -> bytes:
    """The port's hybrid ``TrainState`` (any of the port's models,
    ``torch.optim.Adam``) as the bytes ``flax.serialization.to_bytes`` writes for the reference's
    ``TrainState`` carrying the same arrays: ``params``, ``batch_stats`` and
    ``opt_state`` (``_dense_tree``), ``step`` and ``loss_scale`` (``None``,
    or ``scale`` and ``good_steps``)."""
    ls = state.loss_scale
    tree = {
        **_dense_tree(state),
        "step": np.asarray(state.step, np.int32),
        "loss_scale": None if ls is None else {"scale": np.asarray(ls.scale, np.float32),
                                               "good_steps": np.asarray(ls.good_steps, np.int32)},
    }
    return msgpack_serialize(tree)


def _load_dense_tree(state, tree: Mapping) -> None:
    """Load ``_dense_tree``'s leaves of ``tree`` into ``state`` in place:
    the model's parameters and batch statistics, Adam's moments and
    ``step`` tensors (those that exist are overwritten, so a captured or
    cached step stays valid; missing ones are made as Adam makes them).
    Under a ring or sharded dense sync, this rank's rows of the wrapper go
    to ``state.sync`` (``SyncState.load_opt_state_tree``)."""
    model, opt = state.model, _adam_of(state)
    opt_tree = tree["opt_state"]
    sync = getattr(state, "sync", None)
    if sync is not None and sync.wrapped:
        opt_tree = sync.load_opt_state_tree(opt_tree)  # this rank's rows of the wrapper
    adam = opt_tree["0"]
    sharded = sync is not None and sync.sharded  # the moments are the shard's: the model's Adam keeps none
    leaves = _check_paths(model, tree["params"], "the bytes")
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    count = float(np.asarray(adam["count"]))
    batch_stats_from_flax(model, tree["batch_stats"])
    with torch.no_grad():
        for path, p, transposed in leaves:
            host = [_at(t, path) for t in ((tree["params"],) if sharded else (tree["params"], adam["mu"], adam["nu"]))]
            host = [_host_tensor(a.T if transposed else a).to(p.device) for a in host]
            if host[0].shape != p.shape or host[0].dtype != p.dtype:
                raise ValueError(f"{'/'.join(path)}: {host[0].dtype} {tuple(host[0].shape)} in the bytes, "
                                 f"{p.dtype} {tuple(p.shape)} in the model")
            p.copy_(host[0])
            if sharded:
                continue
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


def train_state_from_flax_bytes(state, raw: bytes):
    """Load the bytes of a reference ``TrainState`` (or of
    ``train_state_to_flax_bytes``) into ``state`` in place: the dense leaves
    (``_load_dense_tree``), the step and the loss scale. Returns
    ``state``."""
    tree = msgpack_restore(raw)
    if (tree["loss_scale"] is None) != (state.loss_scale is None):
        raise ValueError("the bytes and the state disagree on a dynamic loss scale")
    _load_dense_tree(state, tree)
    state.step = int(np.asarray(tree["step"]))
    if state.loss_scale is not None:
        state.loss_scale.scale = float(np.asarray(tree["loss_scale"]["scale"], np.float32))
        state.loss_scale.good_steps = int(np.asarray(tree["loss_scale"]["good_steps"]))
    return state


def cached_state_to_flax_bytes(state) -> bytes:
    """The port's ``CachedTrainState`` (``embedding.hbm_cache``) as the
    bytes ``flax.serialization.to_bytes`` writes for the reference's
    ``CachedTrainState`` carrying the same arrays, in its field order:
    ``params``, ``batch_stats`` and ``opt_state`` (``_dense_tree``), each
    group's table (f32, or bf16 for bf16 pools) and optimizer state by
    group name (the state's order), ``emb_batch_state``, ``step`` and
    ``loss_scale`` (``None`` for a static scale, else ``scale`` f32 and
    ``good_steps`` int32)."""
    ls = state.loss_scale
    tree = {
        **_dense_tree(state),
        "tables": {g: _host_array(t) for g, t in state.tables.items()},
        "emb_state": {g: {k: _host_array(v) for k, v in st.items()} for g, st in state.emb_state.items()},
        "emb_batch_state": _host_array(state.emb_batch_state),
        "step": _host_array(state.step),
        "loss_scale": None if ls is None else {"scale": _host_array(ls.scale).astype(np.float32).reshape(()),
                                               "good_steps": _host_array(ls.good_steps).astype(np.int32).reshape(())},
    }
    return msgpack_serialize(tree)


def cached_state_from_flax_bytes(state, raw: bytes):
    """Load the bytes of a reference ``CachedTrainState`` (or of
    ``cached_state_to_flax_bytes``) into the port's ``state`` in place: the
    dense leaves (``_load_dense_tree``), every group's pool and optimizer
    state, ``emb_batch_state``, ``step`` and the loss scale; the groups,
    their keys, shapes and dtypes (a bf16 pool's too) must be the state's,
    and both or neither must carry a dynamic loss scale. Returns
    ``state``."""
    tree = msgpack_restore(raw)
    if (tree["loss_scale"] is None) != (state.loss_scale is None):
        raise ValueError("the bytes and the state disagree on a dynamic loss scale")
    live = {"tables": state.tables, "emb_state": state.emb_state}
    for key, have in live.items():
        if sorted(tree[key]) != sorted(have) or sorted(_flat_paths(tree[key])) != sorted(_flat_paths(have)):
            raise ValueError(f"the bytes' {key} hold {sorted(_flat_paths(tree[key]))}, the state's "
                             f"{sorted(_flat_paths(have))}")
    pairs = [(state.emb_batch_state, tree["emb_batch_state"]), (state.step, tree["step"])]
    if state.loss_scale is not None:
        pairs += [(state.loss_scale.scale, tree["loss_scale"]["scale"]),
                  (state.loss_scale.good_steps, tree["loss_scale"]["good_steps"])]
    pairs += [(t, tree["tables"][g]) for g, t in state.tables.items()]
    pairs += [(v, tree["emb_state"][g][k]) for g, st in state.emb_state.items() for k, v in st.items()]
    host = [_host_tensor(a) for _, a in pairs]
    for (t, _), h in zip(pairs, host):
        if h.shape != t.shape or h.dtype != t.dtype:
            raise ValueError(f"{h.dtype} {tuple(h.shape)} in the bytes for a {t.dtype} {tuple(t.shape)} tensor")
    _load_dense_tree(state, tree)
    with torch.no_grad():
        for (t, _), h in zip(pairs, host):
            t.copy_(h)
    return state


def model_from_flax_bytes(model: torch.nn.Module, raw: bytes) -> torch.nn.Module:
    """Load the ``params`` and ``batch_stats`` of a reference ``TrainState``'s
    bytes (or of ``train_state_to_flax_bytes``) into a bare ``model``, in
    place (no optimizer: what serving needs). Returns ``model``."""
    tree = msgpack_restore(raw)
    model.load_state_dict(state_dict_from_flax(model, tree["params"], tree["batch_stats"]))
    return model


def seeded_flax_params_like(model: torch.nn.Module, seed: int) -> Dict:
    """Random parameters in the flax layout for ``model`` (its
    ``flax_modules()``), from a numpy seed, drawn leaf by leaf in call
    order: LeCun-normal kernels, small normal biases (non-zero, so a check
    also covers the bias path) and bare parameters, batch norm scales 1
    plus a small normal."""
    rng = np.random.default_rng(seed)
    norms = {id(m.scale) for _, m in model.flax_modules() if isinstance(m, BatchNorm)}
    out: Dict = {}
    for path, p, transposed in flax_leaves(model):
        if transposed:
            a, b = p.shape[1], p.shape[0]
            value = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
        else:
            value = ((1.0 if id(p) in norms else 0.0)
                     + 0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def seeded_batch_stats_like(model: torch.nn.Module, seed: int) -> Dict:
    """Random batch statistics in flax's layout for ``model``, from a numpy
    seed: normal means, variances in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path, t in stats_leaves(model):
        shape = tuple(t.shape)
        value = rng.standard_normal(shape) if path[-1] == "mean" else rng.uniform(0.5, 2.0, shape)
        leaves.append((path, value.astype(np.float32)))
    return _nest(leaves)


# ---------------------------------------------------------------------------
# The fused tier's whole state (``persia_tpu/parallel/fused_ctx.py``'s
# checkpoint): every leaf of the reference's ``FusedTrainState`` for any of
# the port's models trained with ``optax.adam``, keyed by its
# ``jax.tree_util.keystr`` path, in the reference's leaf order (dict keys
# sorted at every level).

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


def _keystr(path: Path) -> str:
    return "".join(f"['{k}']" for k in path)


def _fused_leaves(state) -> List[Tuple[str, Callable[[], np.ndarray]]]:
    """(path, array getter) of every leaf, in the reference's order:
    ``params`` (kernels (in, out)), ``batch_stats`` (none for a model
    without batch norms), Adam's ``count``, ``mu`` and ``nu``, the tables,
    their optimizer state, the batch powers and the step."""
    params = sorted(flax_leaves(state.model), key=lambda leaf: leaf[0])
    stats = sorted(stats_leaves(state.model), key=lambda leaf: leaf[0])
    opt = state.optimizer.state
    out: List[Tuple[str, Callable[[], np.ndarray]]] = []

    def dense(prefix, get):
        for path, p, transposed in params:
            out.append((prefix + _keystr(path),
                        lambda p=p, tr=transposed: np.ascontiguousarray(_host_array(get(p)).T) if tr
                        else _host_array(get(p))))

    dense(".params", lambda p: p)
    for path, t in stats:
        out.append((".batch_stats" + _keystr(path), lambda t=t: _host_array(t)))
    first = params[0][1]
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
    arrays in ``manifest``'s order): ``model``'s parameters, its batch
    statistics (the manifest must hold exactly the model's) and
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
    stats: Dict = {}
    moments: Dict[str, Dict] = {"mu": {}, "nu": {}}
    tables, emb_state = {}, {}
    count = batch_state = step = None

    def put(a, live):
        if live is None:
            return _host_tensor(a).to(dev)
        return live.copy_(_host_tensor(a).view(live.shape))

    def nest(tree, keys, a):
        for k in keys[:-1]:
            tree = tree.setdefault(k, {})
        tree[keys[-1]] = a

    for path, a in zip(manifest, arrays):
        keys = _PATH_KEYS.findall(path)
        if path.startswith(".params["):
            nest(params, keys, a)
        elif path.startswith(".batch_stats["):
            nest(stats, keys, a)
        elif path == ".opt_state[0].count":
            count = a
        elif path.startswith((".opt_state[0].mu[", ".opt_state[0].nu[")):
            nest(moments[path[14:16]], keys, a)
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
    model.load_state_dict(state_dict_from_flax(model, params, stats))
    model.to(dev)
    prepare_dense_optimizer(optimizer, dev)
    for p, st in adam_state_from_optax(model, moments["mu"], moments["nu"], count).items():
        for k, v in st.items():
            optimizer.state[p][k].copy_(v)
    if into is not None:
        return into
    for name in tables:
        emb_state.setdefault(name, {})
    return FusedTrainState(model=model, optimizer=optimizer, tables=tables, emb_state=emb_state,
                           emb_batch_state=batch_state, step=step)
