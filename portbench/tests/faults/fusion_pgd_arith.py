"""Faults of the fusion PGD with arithmetic fusion: the PGD loop's
(``_pgd.py``)."""

from portbench.tests.faults._pgd import FAULTS as PGD

FAULTS = dict(PGD)
