"""Checkpoint files and the parameter bridge to the port's modules
(counterpart of ``lightning_pose_tpu/train/checkpoints.py``).

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
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch
from torch import nn

__all__ = [
    "load_checkpoint",
    "load_flax_variables",
    "save_checkpoint",
    "state_dict_from_flax",
    "state_dict_to_flax",
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
    path: str, params: dict, batch_stats: dict, step: int = 0, epoch: int = 0
) -> None:
    """Atomically write numpy trees as a flax-msgpack checkpoint file that
    the reference's ``load_checkpoint`` reads."""
    import msgpack

    payload = {
        "params": params,
        "batch_stats": batch_stats,
        "step": int(step),
        "epoch": int(epoch),
        "extra": {},
    }
    data = msgpack.packb(payload, default=_ext_default, strict_types=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


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


def _is_deconv(modules: tuple[str, ...]) -> bool:
    return modules[-1].startswith("deconv")


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """Map the reference's flax ``params`` and ``batch_stats`` (numpy trees)
    to a torch ``state_dict`` of the port's modules. Each flax leaf makes one
    key; BatchNorm layers also get ``num_batches_tracked = 0``."""
    out: dict[str, torch.Tensor] = {}

    def put(key: str, value: np.ndarray) -> None:
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(value, order="C"))

    for path, value in _flatten(params).items():
        modules, leaf = path[:-1], path[-1]
        prefix = _torch_module(modules)
        if leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected a 4-d conv kernel")
            if _is_deconv(modules):  # (kh, kw, in, out) -> (in, out, kh, kw), flipped
                value = np.flip(value, (0, 1)).transpose(2, 3, 0, 1)
            else:  # HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            put(f"{prefix}.weight", value)
        elif leaf in _PARAM_LEAVES:
            put(f"{prefix}.{_PARAM_LEAVES[leaf]}", value)
            if leaf == "scale":
                put(f"{prefix}.num_batches_tracked", np.zeros((), dtype=np.int64))
        else:
            raise ValueError(f"unknown flax parameter {'/'.join(path)}")
    for path, value in _flatten(batch_stats).items():
        modules, leaf = path[:-1], path[-1]
        if leaf not in _STAT_LEAVES:
            raise ValueError(f"unknown flax batch statistic {'/'.join(path)}")
        put(f"{_torch_module(modules)}.{_STAT_LEAVES[leaf]}", value)
    return out


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """Inverse of :func:`state_dict_from_flax`: ``(params, batch_stats)``
    numpy trees in the reference's layout."""
    params: dict = {}
    batch_stats: dict = {}
    stat_names = {v: k for k, v in _STAT_LEAVES.items()}
    bn_modules = {
        key.rsplit(".", 1)[0] for key in state_dict if key.endswith(".running_mean")
    }

    def put(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
        for name in path[:-1]:
            tree = tree.setdefault(name, {})
        tree[path[-1]] = np.ascontiguousarray(value)

    for key, tensor in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        value = tensor.detach().cpu().numpy()
        modules = _flax_modules(module)
        if leaf == "num_batches_tracked":
            continue
        if leaf in stat_names:
            put(batch_stats, modules + (stat_names[leaf],), value)
        elif leaf == "weight" and module in bn_modules:
            put(params, modules + ("scale",), value)
        elif leaf == "weight":
            if _is_deconv(modules):
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
