"""Sharded checkpoints with ``torch.distributed.checkpoint`` (DCP; port of
``tpufusion/io/orbax_io.py``), the production path beside ``params_io``.

``params_io`` (npz) gathers every array to one host: fine for converted
model weights, wrong for multi-device state, which it would unshard on save
and replicate on restore. DCP writes each rank's shards of a DTensor leaf
from the rank that owns them and restores onto the template's placements,
so checkpoint / resume composes with the ``parallel`` mesh
(``io/attack_state.py::run_whitebox_sharded_resumable``). Without a process
group it runs as one rank.

A tree is a nest of dicts, lists and tuples; its leaves are tensors
(DTensors or plain, every rank holding a plain one whole) and Python
scalars, stored under their ``/``-joined paths.
"""

from __future__ import annotations

import os

import torch.distributed.checkpoint as dcp

from tpufusion_torch.io.attack_state import _leaves, _rebuild_from


def save_checkpoint(path: str, tree) -> str:
    """Write ``tree`` to the directory ``path``, every rank its shards."""
    path = os.path.abspath(path)
    dcp.save(dict(_leaves(tree)), checkpoint_id=path)
    return path


def restore_checkpoint(path: str, template):
    """Restore a checkpoint onto ``template``'s structure AND placements:
    the template's tensors (DTensor leaves: each rank's local shards) are
    filled in place, its scalars replaced; returns the restored tree. Pass a
    freshly built state placed the way the restored one should be. Raises
    ``RuntimeError`` when the checkpoint does not fit the template."""
    flat = dict(_leaves(template))
    try:
        dcp.load(flat, checkpoint_id=os.path.abspath(path))
    except dcp.api.CheckpointException as e:
        # a BaseException in DCP: raise an Exception, as a failed restore is
        # an ordinary error for the caller
        raise RuntimeError(f"cannot restore {path} onto the template: {e}") from None
    return _rebuild_from(template, flat)
