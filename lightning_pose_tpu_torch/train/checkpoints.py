"""Checkpoint files and the parameter bridge to the port's modules
(counterpart of ``lightning_pose_tpu/train/checkpoints.py``).

Checkpoints keep the JAX package's naming contract:
``<model_dir>/tb_logs/<model_name>/version_N/checkpoints/epoch=E-step=S-best.ckpt``
(and ``-last.ckpt``, and ``epoch=E-step=S.ckpt`` every n epochs), found by
``utils/io.ckpt_path_from_base_path``. A ``-last.ckpt`` also holds the
optimizer state (``opt_state``), which ``training.resume`` continues from.

The reference writes checkpoints as flax-msgpack files
(``flax.serialization.msgpack_serialize`` of ``{"params", "batch_stats",
"step", "epoch", "extra"}``). They are read and written here with
``msgpack`` alone: an array is msgpack ext type 1 holding the packed tuple
``(shape, dtype name, C-order bytes)``, a numpy scalar ext type 3 holding
the same for a 0-d array.

The bridge maps flax parameter trees to a torch ``state_dict`` and back:
conv kernels HWIO <-> OIHW, transposed-conv kernels flipped in both spatial
axes and (kh, kw, in, out) <-> (in, out, kh, kw), BatchNorm
``scale/bias/mean/var`` <-> ``weight/bias/running_mean/running_var``, and
flax module names to torchvision's (``layer1_0`` <-> ``layer1.0``,
``downsample_conv``/``downsample_bn`` <-> ``downsample.0``/``downsample.1``).
The context head's names are the same in both packages
(``head/head_sf/deconv*``, ``head/head_mf/{W_pre, W_f, W_b, H_f_conv,
H_b_conv, H_f_deconv, H_b_deconv}``); its grouped 2x2 transposed convs
(``H_*_deconv``, one group per output channel) regroup their kernels
(``models/heads/heatmap_mhcrnn.grouped_deconv_kernel_from_flax``).
The ViT's names are the same in both packages too (``patch_embed``,
``cls_token``, ``pos_embed``, ``block{i}/{ln1, ln2, attn, mlp}``, ``ln``, and
the multiview model's ``view_embeddings``): a ``Dense`` kernel ``(in, out)``
is a ``Linear`` weight ``(out, in)``, the attention's ``DenseGeneral``
kernels keep their 3-d flax shapes, and a LayerNorm's ``scale`` is its
``weight``. So are the other transformers' (DINOv2, DINOv3, SAM, SAM2
Hiera: ``Dense`` layers, LayerScale's ``lambda``, ``register_tokens``, and
the SAM and Hiera position tables ``pos_embed``/``pos_embed_window`` in
flax's ``(1, h, w, C)``, which the port keeps). A BatchNorm is a module
with batch statistics.

The optimizer state is carried across both ways as well
(:func:`optimizer_state_to_flax`, :func:`load_optimizer_state_from_flax`).
The JAX package's optimizer is ``optax.multi_transform`` over the
``backbone`` and ``head`` groups, each ``optax.adam`` (a chain of
``scale_by_adam`` and the schedule) or ``optax.adamw`` (with the weight
decay between them), and ``flax.serialization.to_state_dict`` writes it as::

    {"inner_states": {group: {"inner_state": {
        "0": {"count": c, "mu": tree, "nu": tree},  # scale_by_adam
        "1": {"count": c},                          # the schedule (adam)
        # adamw: "1": {} (the weight decay), "2": {"count": c}
    }}}}

where ``tree`` is the whole parameter tree with the other group's leaves
written as ``{}`` (optax's ``MaskedNode``) and ``c`` an int32 count of
updates. ``torch.optim.Adam``/``AdamW`` keep ``exp_avg`` (mu),
``exp_avg_sq`` (nu) and ``step`` (the count) per parameter; a moment takes
exactly its parameter's layout transform of the bridge.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any

import numpy as np
import torch
from torch import nn

__all__ = [
    "checkpoint_dir",
    "find_resume_checkpoint",
    "latest_version_dir",
    "load_checkpoint",
    "load_flax_variables",
    "load_optimizer_state_from_flax",
    "next_version_dir",
    "optimizer_state_to_flax",
    "remove_checkpoint",
    "resolve_checkpoint_path",
    "save_checkpoint",
    "save_module",
    "state_dict_from_flax",
    "state_dict_to_flax",
    "warm_start",
]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _unpack_array(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    dtype = np.dtype(dtype_name.decode())
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _unpack_array(data)
    if code == _EXT_NPSCALAR:
        return _unpack_array(data)[()]
    raise ValueError(f"checkpoint holds msgpack ext type {code}, which is not an array")


def _pack_array(arr: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_default(obj: Any) -> Any:
    import msgpack

    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _pack_array(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _pack_array(np.asarray(obj)))
    raise TypeError(f"cannot write {type(obj).__name__} to a checkpoint")


def _check_not_chunked(tree: Any) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise NotImplementedError(
                "checkpoint holds an array split into chunks (over 1 GiB); "
                "the port does not read those"
            )
        for value in tree.values():
            _check_not_chunked(value)


def load_checkpoint(path: str) -> dict:
    """Read a flax-msgpack checkpoint file into numpy trees."""
    import msgpack

    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; the port reads msgpack "
            "checkpoint files only"
        )
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    _check_not_chunked(tree)
    return tree


def save_checkpoint(
    path: str,
    params: dict,
    batch_stats: dict,
    step: int = 0,
    epoch: int = 0,
    extra: dict | None = None,
    backend: str = "msgpack",
    opt_state: Any = None,
) -> None:
    """Atomically write numpy trees as a flax-msgpack checkpoint file that
    the reference's ``load_checkpoint`` reads. ``opt_state``: the optimizer
    state in the JAX package's layout (:func:`optimizer_state_to_flax`), for
    resume checkpoints only."""
    import msgpack

    if backend == "orbax":
        raise NotImplementedError(
            "Orbax checkpoints are not ported (ROADMAP queue 1, item 4: the port writes and reads msgpack only)"
        )
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    payload = {
        "params": params,
        "batch_stats": batch_stats,
        "step": int(step),
        "epoch": int(epoch),
        "extra": extra or {},
    }
    if opt_state is not None:
        payload["opt_state"] = opt_state
    data = msgpack.packb(payload, default=_ext_default, strict_types=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def next_version_dir(model_dir: str, model_name: str) -> str:
    """A fresh ``tb_logs/<model_name>/version_N`` directory path."""
    base = os.path.join(model_dir, "tb_logs", model_name)
    versions = [
        int(m.group(1))
        for p in glob.glob(os.path.join(glob.escape(base), "version_*"))
        if (m := re.search(r"version_(\d+)$", p))
    ]
    return os.path.join(base, f"version_{max(versions) + 1 if versions else 0}")


def latest_version_dir(model_dir: str, model_name: str) -> str | None:
    """The highest existing ``version_N`` directory of a model, or None."""
    pattern = os.path.join(glob.escape(model_dir), "tb_logs", glob.escape(model_name), "version_*")
    versions = [
        (int(m.group(1)), d)
        for d in glob.glob(pattern)
        if (m := re.search(r"version_(\d+)$", d)) and os.path.isdir(d)
    ]
    return max(versions)[1] if versions else None


def find_resume_checkpoint(model_dir: str, model_name: str) -> str | None:
    """The ``*-last.ckpt`` of the highest step in the highest version
    directory (the full training state, the optimizer's included), or None."""
    vdir = latest_version_dir(model_dir, model_name)
    if vdir is None:
        return None
    matches = glob.glob(os.path.join(glob.escape(vdir), "checkpoints", "*-last.ckpt"))
    if not matches:
        return None

    def step(f: str) -> int:
        m = re.search(r"step=(\d+)", f)
        return int(m.group(1)) if m else -1

    return max(matches, key=step)


def checkpoint_dir(version_dir: str) -> str:
    """``<version_dir>/checkpoints``, created if missing."""
    d = os.path.join(version_dir, "checkpoints")
    os.makedirs(d, exist_ok=True)
    return d


def remove_checkpoint(path: str) -> None:
    """Delete a checkpoint, a file or an Orbax directory."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def resolve_checkpoint_path(path: str) -> str:
    """A ``cfg.model.checkpoint`` value -> a checkpoint file: the path itself,
    or for a model directory the first ``**/*.ckpt`` under it."""
    if not os.path.isdir(path) or path.endswith(".ckpt"):
        return path
    matches = sorted(glob.glob(os.path.join(path, "**", "*.ckpt"), recursive=True))
    if not matches:
        raise FileNotFoundError(f"no *.ckpt found under model directory {path}")
    return matches[0]


def save_module(
    path: str,
    module: nn.Module,
    step: int,
    epoch: int,
    extra: dict | None = None,
    optimizer: torch.optim.Optimizer | None = None,
) -> None:
    """Write ``module``'s weights and BatchNorm statistics as a checkpoint,
    with ``optimizer``'s state when given (a resume checkpoint)."""
    params, batch_stats = state_dict_to_flax(module.state_dict())
    opt_state = None if optimizer is None else optimizer_state_to_flax(module, optimizer)
    save_checkpoint(path, params, batch_stats, step, epoch, extra=extra, opt_state=opt_state)


def warm_start(module: nn.Module, path: str) -> bool:
    """Load ``cfg.model.checkpoint`` (a checkpoint file or a model
    directory) into ``module``: the whole model when it fits, else the
    backbone alone (a head of another size, e.g. another keypoint count).
    Returns True when the whole model was loaded."""
    ckpt = load_checkpoint(resolve_checkpoint_path(path))
    state = state_dict_from_flax(ckpt["params"], ckpt.get("batch_stats") or {})
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}

    def fits(keys) -> bool:
        return all(k in state and tuple(state[k].shape) == own[k] for k in keys)

    if set(state) == set(own) and fits(own):
        module.load_state_dict(state, strict=True)
        return True
    backbone = [k for k in own if k.startswith("backbone.")]
    if not fits(backbone):
        raise ValueError(f"{path} holds no backbone of this model")
    module.load_state_dict({k: state[k] for k in backbone}, strict=False)
    return False


# -- parameter bridge ------------------------------------------------------------

_BLOCK = re.compile(r"layer(\d+)_(\d+)")
_PARAM_LEAVES = {"scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _torch_module(flax_modules: tuple[str, ...]) -> str:
    parts = []
    for name in flax_modules:
        block = _BLOCK.fullmatch(name)
        if block:
            parts.append(f"layer{block[1]}.{block[2]}")
        elif name == "downsample_conv":
            parts.append("downsample.0")
        elif name == "downsample_bn":
            parts.append("downsample.1")
        else:
            parts.append(name)
    return ".".join(parts)


def _flax_modules(torch_module: str) -> tuple[str, ...]:
    tokens = torch_module.split(".")
    out: list[str] = []
    i = 0
    while i < len(tokens):
        name = tokens[i]
        nxt = tokens[i + 1] if i + 1 < len(tokens) else None
        if re.fullmatch(r"layer\d+", name) and nxt is not None and nxt.isdigit():
            out.append(f"{name}_{nxt}")
            i += 2
        elif name == "downsample" and nxt in ("0", "1"):
            out.append("downsample_conv" if nxt == "0" else "downsample_bn")
            i += 2
        else:
            out.append(name)
            i += 1
    return tuple(out)


# flax ConvTranspose(3x3, stride 2, "SAME") layers, SameConvTranspose2d here
_DECONVS = ("W_pre", "W_f", "W_b")
# the CRNN's grouped 2x2 transposed convs, one group per output channel
_GROUPED_DECONVS = ("H_f_deconv", "H_b_deconv")


def _is_deconv(modules: tuple[str, ...]) -> bool:
    return modules[-1].startswith("deconv") or modules[-1] in _DECONVS


def _is_grouped_deconv(modules: tuple[str, ...]) -> bool:
    return modules[-1] in _GROUPED_DECONVS


# parameters that are not layer weights, kept in their flax shapes: the
# transformers' tokens and position tables, the view embeddings and
# LayerScale's lambda
_EMBEDDINGS = ("cls_token", "register_tokens", "pos_embed", "pos_embed_window", "view_embeddings", "lambda")


def _kernel_from_flax(modules: tuple[str, ...], value: np.ndarray, path: tuple[str, ...]) -> np.ndarray:
    from lightning_pose_tpu_torch.models.heads.heatmap_mhcrnn import grouped_deconv_kernel_from_flax

    if value.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return value.T
    if value.ndim == 3:  # the attention's DenseGeneral keeps its flax shape
        return value
    if value.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: expected a 2-d, 3-d or 4-d kernel")
    if _is_grouped_deconv(modules):  # (2, 2, in/G, out) -> (in, out/G, 2, 2), G = out
        return grouped_deconv_kernel_from_flax(value, groups=value.shape[3])
    if _is_deconv(modules):  # (kh, kw, in, out) -> (in, out, kh, kw), flipped
        return np.flip(value, (0, 1)).transpose(2, 3, 0, 1)
    return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """Map the reference's flax ``params`` and ``batch_stats`` (numpy trees)
    to a torch ``state_dict`` of the port's modules. Each flax leaf makes one
    key; BatchNorm layers also get ``num_batches_tracked = 0``."""
    out: dict[str, torch.Tensor] = {}
    stats = _flatten(batch_stats)
    bn_modules = {path[:-1] for path in stats}

    def put(key: str, value: np.ndarray) -> None:
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(value, order="C"))

    for path, value in _flatten(params).items():
        modules, leaf = path[:-1], path[-1]
        prefix = _torch_module(modules)
        if leaf == "kernel":
            put(f"{prefix}.weight", _kernel_from_flax(modules, value, path))
        elif leaf in _PARAM_LEAVES:
            put(f"{prefix}.{_PARAM_LEAVES[leaf]}", value)
            if leaf == "scale" and modules in bn_modules:
                put(f"{prefix}.num_batches_tracked", np.zeros((), dtype=np.int64))
        elif leaf in _EMBEDDINGS:
            put(f"{prefix}.{leaf}" if prefix else leaf, value)
        else:
            raise ValueError(f"unknown flax parameter {'/'.join(path)}")
    for path, value in stats.items():
        modules, leaf = path[:-1], path[-1]
        if leaf not in _STAT_LEAVES:
            raise ValueError(f"unknown flax batch statistic {'/'.join(path)}")
        put(f"{_torch_module(modules)}.{_STAT_LEAVES[leaf]}", value)
    return out


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """Inverse of :func:`state_dict_from_flax`: ``(params, batch_stats)``
    numpy trees in the reference's layout."""
    from lightning_pose_tpu_torch.models.heads.heatmap_mhcrnn import grouped_deconv_kernel_to_flax

    params: dict = {}
    batch_stats: dict = {}
    stat_names = {v: k for k, v in _STAT_LEAVES.items()}

    def put(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
        for name in path[:-1]:
            tree = tree.setdefault(name, {})
        tree[path[-1]] = np.ascontiguousarray(value)

    for key, tensor in state_dict.items():
        module, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        value = tensor.detach().cpu().numpy()
        modules = _flax_modules(module) if module else ()
        if leaf == "num_batches_tracked":
            continue
        if leaf in stat_names:
            put(batch_stats, modules + (stat_names[leaf],), value)
        elif leaf in _EMBEDDINGS:
            put(params, modules + (leaf,), value)
        elif leaf == "weight" and value.ndim == 1:  # BatchNorm or LayerNorm
            put(params, modules + ("scale",), value)
        elif leaf == "weight":
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 3:
                pass
            elif _is_grouped_deconv(modules):
                groups = state_dict[f"{module}.bias"].shape[0]
                value = grouped_deconv_kernel_to_flax(value, groups=groups)
            elif _is_deconv(modules):
                value = np.flip(value.transpose(2, 3, 0, 1), (0, 1))
            else:
                value = value.transpose(2, 3, 1, 0)
            put(params, modules + ("kernel",), value)
        elif leaf == "bias":
            put(params, modules + ("bias",), value)
        else:
            raise ValueError(f"unknown state_dict entry {key}")
    return params, batch_stats


def load_flax_variables(module: nn.Module, params: dict, batch_stats: dict) -> None:
    """Load flax trees into ``module``. Raises (``load_state_dict(strict=True)``)
    unless the keys are exactly the module's and every shape matches; each
    key is set once (:func:`state_dict_from_flax` raises on a repeat)."""
    module.load_state_dict(state_dict_from_flax(params, batch_stats), strict=True)


# -- optimizer state ------------------------------------------------------------


def _group_of(flax_top: str) -> str:
    """The optimizer group of a top-level flax module (the JAX package's
    ``make_optimizer`` labels)."""
    return "backbone" if flax_top == "backbone" else "head"


def _masked(tree: Any) -> Any:
    """``tree`` with every leaf written as optax's ``MaskedNode``: ``{}``."""
    return {k: _masked(v) for k, v in tree.items()} if isinstance(tree, dict) else {}


def _unmasked(tree: dict) -> dict:
    """``tree`` without its ``{}`` leaves."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            value = _unmasked(value)
            if value:
                out[key] = value
        else:
            out[key] = value
    return out


def _is_adamw(optimizer: torch.optim.Optimizer) -> bool:
    if isinstance(optimizer, torch.optim.AdamW):
        return True
    if isinstance(optimizer, torch.optim.Adam):
        return False
    raise TypeError(f"no checkpoint layout for {type(optimizer).__name__}")


def optimizer_state_to_flax(module: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer``'s state (Adam or AdamW over the groups ``backbone`` and
    ``head``, as ``trainer.make_optimizer`` makes it) in the layout that
    ``flax.serialization.to_state_dict`` gives the JAX package's optax state
    (module docstring). A parameter that has no state (never given a
    gradient, as the ViT's unused CLS token; optax steps it with zeros) has
    zero moments; a group's count is the step of its other parameters,
    which must agree."""
    adamw = _is_adamw(optimizer)
    names = {p: n for n, p in module.named_parameters()}
    mu: dict[str, torch.Tensor] = {}
    nu: dict[str, torch.Tensor] = {}
    counts: dict[str, set[int]] = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            mu[names[p]] = state.get("exp_avg", torch.zeros_like(p))
            nu[names[p]] = state.get("exp_avg_sq", torch.zeros_like(p))
            group_counts = counts.setdefault(group["name"], set())
            if "step" in state:
                group_counts.add(int(state["step"]))
    mu_tree, nu_tree = state_dict_to_flax(mu)[0], state_dict_to_flax(nu)[0]
    inner = {}
    for name, group_counts in counts.items():
        if len(group_counts) > 1:
            raise ValueError(f"the {name} group's parameters took different numbers of steps: {sorted(group_counts)}")
        count = np.asarray(group_counts.pop() if group_counts else 0, dtype=np.int32)

        def own(tree: dict) -> dict:
            return {k: v if _group_of(k) == name else _masked(v) for k, v in tree.items()}

        chain = {"0": {"count": count, "mu": own(mu_tree), "nu": own(nu_tree)}}
        if adamw:
            chain.update({"1": {}, "2": {"count": count}})
        else:
            chain["1"] = {"count": count}
        inner[name] = {"inner_state": chain}
    return {"inner_states": inner}


def load_optimizer_state_from_flax(module: nn.Module, optimizer: torch.optim.Optimizer, tree: dict) -> int:
    """Set ``optimizer``'s state from the JAX package's layout (as
    :func:`optimizer_state_to_flax` writes it, or the JAX package's
    ``-last.ckpt``); the moments go to each parameter's device. A parameter
    whose moments are all zero gets no state, as one never given a gradient
    (torch's Adam creates its state at its first gradient). Returns the
    count of updates. Raises if the layout is another optimizer's (Adam
    against AdamW) or a group is missing."""
    adamw = _is_adamw(optimizer)
    names = {p: n for n, p in module.named_parameters()}
    inner = tree["inner_states"]
    scalar_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    counts = set()
    for group in optimizer.param_groups:
        name = group["name"]
        if name not in inner:
            raise ValueError(f"the optimizer state has no {name} group")
        chain = inner[name]["inner_state"]
        if ("2" in chain) != adamw:
            raise ValueError(f"the optimizer state is {'AdamW' if '2' in chain else 'Adam'}'s, the optimizer "
                             f"{type(optimizer).__name__}")
        adam = chain["0"]
        count = int(adam["count"])
        schedule_count = int(chain["2" if adamw else "1"]["count"])
        if schedule_count != count:
            raise ValueError(f"the {name} group's schedule count {schedule_count} is not its Adam count {count}")
        counts.add(count)
        mu = state_dict_from_flax(_unmasked(adam["mu"]), {})
        nu = state_dict_from_flax(_unmasked(adam["nu"]), {})
        for p in group["params"]:
            key = names[p]
            if key not in mu or key not in nu:
                raise ValueError(f"the optimizer state has no moments of {key}")
            if tuple(mu[key].shape) != tuple(p.shape) or tuple(nu[key].shape) != tuple(p.shape):
                raise ValueError(f"the moments of {key} are {tuple(mu[key].shape)}, the parameter {tuple(p.shape)}")
            if count == 0 or not (mu[key].any() or nu[key].any()):
                optimizer.state.pop(p, None)
                continue
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=scalar_dtype),
                "exp_avg": mu[key].to(p.device, p.dtype),
                "exp_avg_sq": nu[key].to(p.device, p.dtype),
            }
    if len(counts) != 1:
        raise ValueError(f"the groups took different numbers of steps: {sorted(counts)}")
    return counts.pop()
