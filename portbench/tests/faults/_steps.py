"""Plants of any attack whose steps run as a ``core.graphs.StepProgram``."""

from __future__ import annotations

import pytest

from tpufusion_torch.core import graphs


def unchanged(monkeypatch):
    """A step that returns its state unchanged (``StepProgram.run`` takes no
    step)."""
    monkeypatch.setattr(graphs.StepProgram, "run", lambda self, n=1: None)


def after_first_step(monkeypatch, fault):
    """``fault`` (a function of a monkeypatch) planted in every step of a
    program's run but its first: on the card the eager step is sound and
    the captured graph, and so every replay, is broken."""
    run = graphs.StepProgram.run

    def run_broken(self, n=1):
        run(self, 1)
        if n > 1:
            with pytest.MonkeyPatch.context() as mp:
                fault(mp)
                run(self, n - 1)

    monkeypatch.setattr(graphs.StepProgram, "run", run_broken)
