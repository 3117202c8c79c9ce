"""Checkpoints in the JAX package's pickle format.

Port of complexhyperbolickge_tpu/train/checkpoint.py.  A checkpoint is a
pickle of a dict with `format_version` (1), `params` (name -> numpy array),
`param_schema` (name -> [shape, dtype name]), `opt_state`, `epoch`,
`best_mrr` and optionally `config`, plus a config.json beside it.  Files
cross between the packages both ways.

GNN params are nested in JAX: params["gnn"] is a list of per-layer dicts
(with w_rel {w, b} and the mlp_curvature list of {w, b}), and the schema of
a nested tree is keyed by jax.tree_util.keystr paths ("['gnn'][0]['w_rel']
['w']").  The port's state_dict keys are the same paths dotted
("gnn.0.w_rel.w"): `params_to_jax` nests them (an integer segment is a list
index), `params_from_jax` flattens a nested tree back, and `_schema` keys a
nested tree by keystr as JAX does, so checkpoints validate in both packages.

A checkpoint written by the JAX trainer pickles its optax optimizer state
(NamedTuples such as ScaleByAdamState), and a plain pickle.load would import
optax and jax to rebuild them.  The loader here stubs every class from
those packages instead: the stubs keep the opt_state's values as plain
tuples, and `opt_state_from_jax` turns them into the port's form.

bfloat16 params are written as ml_dtypes.bfloat16 arrays, as JAX writes
them, when ml_dtypes imports (JAX depends on it; the port does not).
Without it they are widened to float32, exactly, and the schema keeps
"bfloat16": the port's loader reads both forms (JAX's only the first).

A model's state outside its parameters (the running statistics of
CompGCN's ConvE decoder: buffers that state_dict() leaves out) rides in a
`buffers` slot (name -> numpy array), written only when the model has
such state: `state_buffers` reads it from a model and `load_buffers`
puts it back.

The port's trainer writes its own optimizer state in the opt_state slot as
{"lr": float, "state": {param name: {torch state key: numpy array}}}
(train/trainer.py::Trainer.opt_state): numbers and arrays only, so the JAX
package still loads and evaluates a port-written checkpoint.  JAX cannot
resume training from it (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import torch

FORMAT_VERSION = 1

# top-level packages whose pickled classes are replaced by stubs on load
_STUBBED_PACKAGES = frozenset(
    {"optax", "jax", "jaxlib", "chex", "complexhyperbolickge_tpu"})


class PickledStub(tuple):
    """Stand-in for a class of a stubbed package: keeps the constructor
    arguments as a tuple and any pickled state in `state`."""

    state = None

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        self.state = state


class _JaxFreeUnpickler(pickle.Unpickler):
    _stubs: dict = {}

    def find_class(self, module, name):
        if module.split(".", 1)[0] in _STUBBED_PACKAGES:
            key = (module, name)
            if key not in self._stubs:
                self._stubs[key] = type(name, (PickledStub,),
                                        {"__module__": module})
            return self._stubs[key]
        return super().find_class(module, name)


def nest(flat: dict):
    """Dotted names -> the JAX tree: "gnn.0.w_rel.w" -> tree["gnn"][0]["w_rel"]
    ["w"]; a name without dots stays a top-level key."""
    tree: dict = {}
    for name, v in flat.items():
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return _lists(tree)


def _lists(node):
    """Dicts whose keys are 0..n-1 become lists, depth first."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def flatten(tree, prefix: str = "") -> dict:
    """Inverse of nest: a tree of dicts and lists -> dotted name -> leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _keystr(name: str) -> str:
    """A dotted name as jax.tree_util.keystr writes its path."""
    return "".join(f"[{int(p)}]" if p.isdigit() else f"[{p!r}]" for p in name.split("."))


def _stub_nodes(tree):
    """Every node of a stubbed optax state, depth first."""
    yield tree
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _stub_nodes(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _stub_nodes(v)


def opt_state_from_jax(opt_state) -> dict:
    """The optax state of a JAX checkpoint (inject_hyperparams around Adam,
    SparseAdam, the torch-rule Adagrad or SGD, as load_checkpoint's stubs
    give it) -> the port's opt_state: mu -> exp_avg, nu -> exp_avg_sq,
    count (SparseAdam: its global step) -> step, sum_of_squares -> sum, and
    the injected learning rate; nested (GNN) trees are keyed by their
    dotted names."""
    nodes = list(_stub_nodes(opt_state))
    lr = next(n["learning_rate"] for n in nodes
              if isinstance(n, dict) and "learning_rate" in n)
    by_name = {type(n).__name__: n for n in nodes if isinstance(n, PickledStub)}
    if "ScaleByAdamState" in by_name:
        count, mu, nu = by_name["ScaleByAdamState"]
        mu, nu = flatten(mu), flatten(nu)
        state = {k: {"step": np.asarray(count, dtype=np.float32),
                     "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}
    elif "SparseAdamState" in by_name:
        mu, nu, count = by_name["SparseAdamState"]
        mu, nu = flatten(mu), flatten(nu)
        state = {k: {"step": np.asarray(count, dtype=np.float32),
                     "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu}
    elif "_RssState" in by_name:
        (sums,) = by_name["_RssState"]
        count = opt_state[0]  # inject_hyperparams' own step count
        state = {k: {"step": np.asarray(count, dtype=np.float32), "sum": v}
                 for k, v in flatten(sums).items()}
    else:  # SGD keeps no state
        state = {}
    return {"lr": float(lr), "state": state}


def _bf16_to_numpy(t):
    """A bfloat16 tensor on the CPU as ml_dtypes.bfloat16 (the same bits),
    or widened to float32 when ml_dtypes is missing."""
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    return _bf16_to_numpy(t) if t.dtype == torch.bfloat16 else t.numpy()


def _to_torch(v) -> torch.Tensor:
    """A checkpoint array as a tensor; an ml_dtypes bfloat16 array keeps
    its bits."""
    a = np.array(v, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.result_type(v))


def _schema(params) -> dict:
    """name -> [shape, dtype name] of a params tree (numpy arrays or torch
    tensors), flat or nested or dotted: a flat tree keys by name, a nested
    one by keystr path, as the JAX package's _schema does."""
    flat = flatten(params)
    key = (lambda k: k) if all("." not in k for k in flat) else _keystr
    return {key(k): [list(v.shape), _dtype_name(v)] for k, v in flat.items()}


def params_from_jax(np_params, device, dtype: torch.dtype | None = None) -> dict:
    """JAX params (a tree of numpy arrays, as a JAX checkpoint or
    `jax.tree.map(np.asarray, params)` holds them; nested GNN trees too) ->
    dotted name -> tensor on `device`, cast to `dtype` when given.  The
    names are the model's state_dict keys, so the result goes straight into
    load_state_dict."""
    out = {}
    for k, v in flatten(np_params).items():
        t = _to_torch(v)
        out[k] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def params_to_jax(params: dict):
    """Inverse of params_from_jax: dotted name -> tensor (any device) -> the
    JAX tree of numpy arrays that JAX's load_checkpoint reads (nested for a
    GNN, flat otherwise)."""
    return nest({k: _to_numpy(v) for k, v in params.items()})


def state_buffers(model: torch.nn.Module) -> dict:
    """name -> tensor of the model's buffers that state_dict() leaves out
    (non-persistent): the state a checkpoint carries beside the params."""
    keep = model.state_dict().keys()
    return {k: v for k, v in model.named_buffers() if k not in keep}


def load_buffers(model: torch.nn.Module, state: dict):
    """Copy a checkpoint's `buffers` slot into the model's buffers of those
    names (a checkpoint without one changes nothing)."""
    with torch.no_grad():
        for k, v in (state.get("buffers") or {}).items():
            buf = model.get_buffer(k)
            buf.copy_(_to_torch(v).to(device=buf.device, dtype=buf.dtype))


def save_checkpoint(path: str, params: dict, opt_state=None, epoch: int = 0,
                    best_mrr: float | None = None, config: dict | None = None,
                    filename: str = "state.pkl", extra: dict | None = None,
                    buffers: dict | None = None):
    """Write `params` (name -> tensor, e.g. model.state_dict()) in the JAX
    format.  filename='state.pkl' is the best-validation checkpoint;
    config rides inside the checkpoint and in config.json beside it;
    buffers (state_buffers(model)), when not empty, in the `buffers`
    slot."""
    os.makedirs(path, exist_ok=True)
    state = {
        "format_version": FORMAT_VERSION,
        "params": params_to_jax(params),
        # from the tensors: a bfloat16 param widened to float32 stays
        # "bfloat16" here
        "param_schema": _schema(params),
        "opt_state": opt_state,
        "epoch": epoch,
        "best_mrr": best_mrr,
    }
    if buffers:
        state["buffers"] = {k: _to_numpy(v) for k, v in buffers.items()}
    if extra:
        state.update(extra)
    cfg = None
    if config is not None:
        cfg = {
            k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in config.items()
        }
        state["config"] = cfg
    tmp = os.path.join(path, filename + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, os.path.join(path, filename))
    if cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)


def load_checkpoint(path: str, expect_params: dict | None = None,
                    filename: str = "state.pkl",
                    cast_to_expected: bool = False,
                    n_entities: int | None = None) -> dict:
    """Load a checkpoint file without importing jax or optax.

    Validates the stored schema against the stored params and, when
    `expect_params` (name -> tensor or array, e.g. model.state_dict()) is
    given, against the caller's shapes and dtypes, naming the parameter that
    differs.  cast_to_expected=True compares shapes only; the cast itself
    happens when the caller carries the params across with
    params_from_jax(dtype=...).  `params` stay numpy arrays.  n_entities:
    an entity-table leaf (entity, bh, bt) with more rows raises first, as
    the JAX package's mesh resume does: checkpoints are canonical, and
    such a file was written with mesh-padded tables."""
    with open(os.path.join(path, filename), "rb") as f:
        state = _JaxFreeUnpickler(f).load()
    ver = state.get("format_version", 0)
    if ver > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint at {path} has format_version={ver}, newer than this "
            f"code's {FORMAT_VERSION}"
        )
    schema = state.get("param_schema")
    got = _schema(state["params"])
    if schema is not None:
        if _unwiden(got, schema) != schema:
            raise ValueError(
                f"checkpoint at {path} is corrupt: stored params do not match "
                f"their recorded schema"
            )
        got = schema
    for k in ("entity", "bh", "bt"):
        v = state["params"].get(k) if isinstance(state["params"], dict) else None
        if n_entities is not None and v is not None and np.shape(v)[0] > n_entities:
            raise ValueError(
                f"checkpoint leaf shape {np.shape(v)} exceeds the live layout of "
                f"{n_entities} entities: checkpoints are canonical (unpadded) — this "
                "one looks like it was written with mesh-padded tables")
    if expect_params is not None:
        want = _schema(expect_params)
        if cast_to_expected:
            want = {k: v[0] for k, v in want.items()}
            got = {k: v[0] for k, v in got.items()}
        if want != got:
            diffs = [
                f"  {k}: checkpoint {got.get(k)} vs expected {want.get(k)}"
                for k in sorted(set(want) | set(got))
                if want.get(k) != got.get(k)
            ]
            raise ValueError(
                "checkpoint/model mismatch (wrong rank, model, or dtype?):\n"
                + "\n".join(diffs)
            )
    return state


def _unwiden(got: dict, schema: dict) -> dict:
    """The stored params' schema with each float32 leaf that the recorded
    schema calls bfloat16 (the widened form) named bfloat16."""
    out = dict(got)
    for k, v in got.items():
        rec = schema.get(k)
        if rec is not None and rec[1] == "bfloat16" and v == [rec[0], "float32"]:
            out[k] = rec
    return out


def load_into(model: torch.nn.Module, path: str,
              filename: str = "state.pkl") -> dict:
    """Schema-check a checkpoint against `model` (shapes strict, dtypes cast
    to the model's) and load its params and buffers in place; returns the
    state."""
    state = load_checkpoint(path, expect_params=model.state_dict(),
                            filename=filename, cast_to_expected=True)
    p = next(model.parameters())
    model.load_state_dict(params_from_jax(state["params"], p.device, p.dtype))
    load_buffers(model, state)
    return state


def load_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)
