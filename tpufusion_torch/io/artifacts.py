"""Run-dir and artifact management (port of ``tpufusion/io/artifacts.py``;
reference C20).

- auto-numbered attack run dirs (``new_adv_dir``, `attack_main2.py:782-793`);
- ``parameters.txt`` config record (`attack_main2.py:976-989`);
- tensor artifact dumps: the reference ``torch.save``s ``all_adv_inputs.npz``
  / ``all_inputs.npz`` / ``all_rec_loss.npz`` / ``all_inner_feature.npz``
  (`attack_main2.py:1096-1111`); here they are real ``.npz`` files in the
  JAX package's layout (one ``data`` array), so either package reads the
  other's.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Mapping

import numpy as np
import torch


def new_run_folder(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def new_adv_dir(base_dir: str, postfix: str) -> str:
    """Next free ``<n>_<postfix>`` dir under ``base_dir`` (numbering continues
    from the highest existing prefix)."""
    os.makedirs(base_dir, exist_ok=True)
    num = -1
    for entry in glob.glob(os.path.join(base_dir, "*" + os.path.sep)):
        m = re.match(r"(\d+)_", os.path.basename(os.path.dirname(entry)))
        if m:
            num = max(num, int(m.group(1)))
    num += 1
    final = os.path.join(base_dir, f"{num}_{postfix}")
    while os.path.exists(final):
        num += 1
        final = os.path.join(base_dir, f"{num}_{postfix}")
    return new_run_folder(final)


def write_parameters(run_dir: str, params: Mapping, filename: str = "parameters.txt") -> str:
    """Append a ``key value`` record per entry + a machine-readable JSON
    sidecar (the reference writes only the txt).  Repeated calls into the
    same run dir MERGE into the sidecar (later keys win) so it stays
    consistent with the append-only txt record."""
    path = os.path.join(run_dir, filename)
    with open(path, "a") as f:
        for k, v in params.items():
            f.write(f"{k} {v}\n")
    json_path = os.path.splitext(path)[0] + ".json"
    record = {}
    if os.path.exists(json_path):
        try:
            with open(json_path) as f:
                record = json.load(f)
        except (json.JSONDecodeError, OSError):
            record = {}
    record.update(
        {k: v if _jsonable(v) else repr(v) for k, v in params.items()})
    # atomic replace: a crash mid-dump must not leave a truncated sidecar
    # (the merge above would then silently reset it to {})
    tmp = json_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2)
    os.replace(tmp, json_path)
    return path


def _jsonable(v):
    """True only if the WHOLE value serialises (a list holding an np.int64
    passes an isinstance check but blows up json.dump mid-write)."""
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def to_numpy(value) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array of the same
    dtype (bfloat16, which numpy lacks, as float32)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


class ArtifactStore:
    """Accumulate named tensor lists and flush them as ``.npz`` files —
    the periodic+final dump pattern of `attack_main2.py:1096-1111`. A
    tensor reaches the host when it is appended."""

    def __init__(self, run_dir: str):
        self.run_dir = new_run_folder(run_dir)
        self._lists: dict[str, list] = {}

    def append(self, name: str, value) -> None:
        self._lists.setdefault(name, []).append(to_numpy(value))

    def flush(self) -> dict:
        written = {}
        for name, chunks in self._lists.items():
            if not chunks:
                continue
            path = os.path.join(self.run_dir, f"{name}.npz")
            np.savez(path, data=np.concatenate(chunks, axis=0))
            written[name] = path
        return written

    @staticmethod
    def load(path: str) -> np.ndarray:
        with np.load(path) as f:
            return f["data"]
