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

``run_whitebox_sharded_resumable`` is the multi-device form: the
data-parallel white-box attack with sharded checkpoints (``io/dcp_io.py``).
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


def _rebuild_from(template, flat, prefix=""):
    """``template``'s structure with each leaf taken from ``flat`` (keyed
    by the ``_leaves`` paths)."""
    if isinstance(template, dict):
        return {k: _rebuild_from(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild_from(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]


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


def run_whitebox_sharded_resumable(pipeline, inputs, target_img, config, which_adv, mesh,
                                   checkpoint_dir: str, *, checkpoint_every: int = 10):
    """Multi-device form of ``run_whitebox_resumable``: the data-parallel
    white-box attack (``parallel.run_whitebox_sharded`` semantics: padded
    batch over ``data``, which_adv selection) with periodic DCP checkpoints
    of the SHARDED state (``io/dcp_io.py``: each rank writes its rows;
    restore fills the template's shards, so a resumed run continues the
    exact trajectory).

    Checkpoints live under ``checkpoint_dir/step_N``; the newest restorable
    one wins, older ones are pruned after a successful save (the previous
    checkpoint survives any crash mid-save). If checkpoints exist but NONE
    restores (changed batch / size / config), this raises instead of
    restarting from 0, since a restart would prune the prior progress on
    its first save; clear ``checkpoint_dir`` to start over. Returns
    ``(adv_inputs, trace, start_iter)``, the trace (n_selected,
    iterations run in THIS call) of per-image totals, or None."""
    import glob
    import re
    import shutil

    import torch.distributed as dist

    from tpufusion_torch.io.dcp_io import restore_checkpoint, save_checkpoint
    from tpufusion_torch.parallel.sharding import (
        as_dtensors,
        gather_rows,
        make_sharded_whitebox_step,
        prepare_whitebox_batch,
        to_local,
    )

    idx, sub_p, targets_p, n_real = prepare_whitebox_batch(inputs, target_img, which_adv, mesh)
    step, init, place_batch = make_sharded_whitebox_step(pipeline, config, mesh)
    state = init(*place_batch(sub_p, targets_p))
    lead = dist.get_rank() == 0

    os.makedirs(checkpoint_dir, exist_ok=True)
    start = 0
    # only completed step_N directories (a crash mid-save leaves a
    # directory without DCP's .metadata, which restore rejects)
    candidates = sorted(
        (p for p in glob.glob(os.path.join(checkpoint_dir, "step_*"))
         if re.fullmatch(r"step_\d+", os.path.basename(p))),
        key=lambda p: int(p.rsplit("_", 1)[1]), reverse=True)
    errors = []
    for cand in candidates:
        try:
            state = to_local(restore_checkpoint(cand, as_dtensors(mesh, state)))
            start = int(cand.rsplit("_", 1)[1])
            break
        except Exception as e:  # a partial save: fall back to the previous one
            errors.append(f"{os.path.basename(cand)}: {e}")
            print(f"[attack_state] WARNING: could not restore {cand}: {e}")
    if candidates and start == 0 and errors:
        raise RuntimeError(
            f"{checkpoint_dir} holds {len(candidates)} checkpoint(s) but none restored "
            f"(wrong batch/size/config?): {errors[:2]}; refusing to restart from 0 (the "
            "first new save would prune them): clear the directory to start over")

    losses = []
    for i in range(start, config.n_iters):
        state, per = step(state)  # (B,) per-image losses
        losses.append(per)
        done = i + 1
        if checkpoint_every and (done % checkpoint_every == 0 or done == config.n_iters):
            path = os.path.join(checkpoint_dir, f"step_{done}")
            if lead and os.path.exists(path):
                shutil.rmtree(path)
            dist.barrier()
            save_checkpoint(path, as_dtensors(mesh, state))
            dist.barrier()
            if lead:
                for old in glob.glob(os.path.join(checkpoint_dir, "step_*")):
                    if old != path:  # prune older checkpoints
                        shutil.rmtree(old, ignore_errors=True)

    adv = inputs.clone()
    adv[idx] = gather_rows(mesh, state["x"])[:n_real].to(adv.dtype)
    trace = torch.stack(losses, dim=1)[:n_real] if losses else None
    return adv, trace, start
