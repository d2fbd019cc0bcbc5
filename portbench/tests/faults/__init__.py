"""Planted faults, found by the attack's name.

Each module ``<attack>.py`` here (the runner's attack name, as a traffic
mix's ``attack`` gives it) holds ``FAULTS = {name: plant}``: the faults that
a cell running that attack can have, each ``plant(monkeypatch)`` breaking
the port underneath in one way. ``test_portbench_faults.py`` plants each in
a whole CPU run of each cell, and ``control.py --faults`` reads them on the
card. Plants that several attacks share live in the modules whose names
start with ``_`` (no attack's name does): ``_steps.py`` for any attack
whose steps run as a ``StepProgram``, ``_pgd.py`` for the PGD loop. A later
attack adds its module, taking the shared plants by import.
"""

from __future__ import annotations

import importlib


class NoFaults(LookupError):
    """An attack with no module of planted faults."""


def load(attack: str) -> dict:
    """``FAULTS`` of ``attack``'s module; ``NoFaults`` where it has none."""
    name = f"{__name__}.{attack}"
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:  # the module is there, and an import inside it failed
            raise
        raise NoFaults(f"attack {attack!r} has no planted faults: "
                       f"add portbench/tests/faults/{attack}.py with FAULTS") from None
    return module.FAULTS
