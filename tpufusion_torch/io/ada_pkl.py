"""stylegan2-ada ``.pkl`` tensor extraction (port of
``tpufusion/io/ada_pkl.py``).

The reference opens ``ffhq.pkl`` with ``dnnlib.util.open_url`` +
``legacy.load_network_pkl`` and keeps the discriminator ``D``
(`attack_main2.py:934-938`).  Those pickles embed ``torch_utils.persistence``
classes by value; loading them normally requires the original package.  Here
a permissive unpickler substitutes stub classes for ANY missing module, then
the object graph is walked to collect every torch tensor under its attribute
path — enough to rebuild a state dict without the upstream codebase.
"""

from __future__ import annotations

import pickle
from typing import Any, Mapping

import numpy as np
import torch


class _Stub:
    """Placeholder standing in for any unavailable class in the pickle."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_args"] = args
        self.__dict__["_kwargs"] = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        try:
            return super().find_class(module, name)
        except Exception:
            return type(name, (_Stub,), {"__module__": module})


def load_pkl_permissive(path_or_file) -> Any:
    """Unpickle with stubs for missing classes. This runs the pickle's code:
    open only files from a trusted source."""
    if hasattr(path_or_file, "read"):
        return _PermissiveUnpickler(path_or_file).load()
    with open(path_or_file, "rb") as f:
        return _PermissiveUnpickler(f).load()


def collect_tensors(obj: Any, prefix: str = "", out: dict | None = None,
                    _seen: set | None = None) -> dict:
    """Walk an arbitrary object graph, returning {dotted_path: np.ndarray}
    for every torch tensor / ndarray found."""
    out = {} if out is None else out
    _seen = set() if _seen is None else _seen
    oid = id(obj)
    if oid in _seen:
        return out
    _seen.add(oid)

    if isinstance(obj, (torch.Tensor, np.ndarray)):
        arr = obj.detach().cpu().numpy() if hasattr(obj, "detach") else np.asarray(obj)
        out[prefix] = arr
        return out
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            if isinstance(k, str):
                collect_tensors(v, f"{prefix}.{k}" if prefix else str(k), out, _seen)
        return out
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            collect_tensors(v, f"{prefix}.{i}" if prefix else str(i), out, _seen)
        return out
    d = getattr(obj, "__dict__", None)
    if d:
        for k, v in d.items():
            if isinstance(k, str) and not k.startswith("_"):
                collect_tensors(v, f"{prefix}.{k}" if prefix else k, out, _seen)
        # torch modules keep params/buffers in private dicts
        for priv in ("_parameters", "_buffers", "_modules"):
            if priv in d and isinstance(d[priv], Mapping):
                for k, v in d[priv].items():
                    collect_tensors(v, f"{prefix}.{k}" if prefix else str(k), out, _seen)
    return out


def load_network_pkl_tensors(path) -> dict:
    """``legacy.load_network_pkl`` analog: returns
    {network_name: {param_path: ndarray}} for G/D/G_ema entries found."""
    data = load_pkl_permissive(path)
    nets = {}
    if isinstance(data, Mapping):
        for name in ("G", "D", "G_ema"):
            if name in data:
                nets[name] = collect_tensors(data[name])
    if not nets:
        nets["root"] = collect_tensors(data)
    return nets
