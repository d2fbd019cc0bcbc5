"""Mid-attack checkpoint/resume (port of ``tpufusion/io/attack_state.py``) —
failure recovery for long attack runs.

The reference's only resume story is reloading end-of-attack artifacts
(`attack_main2.py:1096-1111`, `interpolation.py:1274-1313`); an interrupted
white-box optimisation restarts from scratch. Here the white-box stepper's
state is a nest of dicts, lists and tuples whose leaves are tensors (the
pixel buffer, the Adam moments, the no-grad reference bundle) and Python
ints (Adam's step count), so a checkpoint is one ``.npz`` holding every leaf
under its ``/``-joined path. Resume rebuilds the state against a template
from the same ``init``: its leaves give the structure, dtypes and device.
A bfloat16 tensor is stored as float32, which holds it exactly.

The multi-chip ``run_whitebox_sharded_resumable`` waits for the port's
scale-out (ROADMAP A.11).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpufusion_torch.io.artifacts import to_numpy

_STEP = "__step__"


def _leaves(tree, prefix=""):
    """``[(path, leaf)]`` of a nest of dicts / lists / tuples, in a fixed
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(template, data, prefix=""):
    if isinstance(template, dict):
        return {k: _rebuild(v, data, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, data, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    got = data[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        if tuple(got.shape) != tuple(template.shape):
            raise ValueError(
                f"checkpoint leaf {prefix[:-1]!r} has shape {tuple(got.shape)} but the "
                f"template's is {tuple(template.shape)}: wrong image size/batch?")
        return torch.from_numpy(np.array(got)).to(device=template.device, dtype=template.dtype)
    return type(template)(got.item())


def save_attack_state(state, path: str, *, step: int) -> str:
    """Persist an attack state (+ iteration counter) to ``path``.

    Writes atomically (tmp file + rename) so a crash mid-write never
    corrupts the previous checkpoint.
    """
    payload = {name: to_numpy(leaf) for name, leaf in _leaves(state)}
    payload[_STEP] = np.asarray(step, np.int64)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_attack_state(path: str, template):
    """Restore ``(state, step)`` from ``path``.

    ``template`` is a freshly-built state with the SAME structure (from the
    attack's ``init``); its leaves supply the structure, dtypes and device.
    """
    names = {name for name, _ in _leaves(template)}
    with np.load(path) as data:
        step = int(data[_STEP])
        saved = set(data.files) - {_STEP}
        if saved != names:
            raise ValueError(
                f"checkpoint {path} holds leaves {sorted(saved ^ names)[:4]} that the "
                f"template state does not (or the other way round): wrong attack/config?")
        state = _rebuild(template, {k: data[k] for k in saved})
    return state, step


def run_whitebox_resumable(pipeline, img, target_img, config,
                           checkpoint_path: str, *, checkpoint_every: int = 10):
    """Host-looped white-box attack with periodic state checkpoints.

    Same semantics as ``attacks.whitebox.run_whitebox_stepwise`` (the batch
    is one problem) but the stepper state is saved to ``checkpoint_path``
    every ``checkpoint_every`` iterations and on completion; if the file
    already exists the run resumes from the recorded iteration (Adam moments
    and the reference bundle restore exactly, so the trajectory is identical
    to an unbroken run). Returns ``(adv, trace, start_iter)`` where
    ``trace`` maps each term to the (iterations executed in THIS call,)
    tensor, or is None when nothing was left to run.
    """
    from tpufusion_torch.attacks.whitebox import make_whitebox_stepper

    init, step = make_whitebox_stepper(pipeline, config)
    state = init(img, target_img)
    start = 0
    if os.path.exists(checkpoint_path):
        state, start = load_attack_state(checkpoint_path, state)
    traces = []
    for i in range(start, config.n_iters):
        state, terms = step(state)
        traces.append(terms)
        done = i + 1
        if checkpoint_every and (done % checkpoint_every == 0
                                 or done == config.n_iters):
            save_attack_state(state, checkpoint_path, step=done)
    trace = ({k: torch.stack([t[k] for t in traces]) for k in traces[0]}
             if traces else None)
    return state["x"], trace, start
