"""Results export (port of ``tpufusion/eval/report.py``; reference C16,
`interpolation.py:1256-1262,1435-1451`).

The reference accumulates one row per fusion batch into a pandas DataFrame
with duplicated column groups

    ['noise']*N + ['cri_spati']*(N+1) + ['cri_arith']*(N+1)
  + ['vg_spati']*(N+1) + ['vg_arith']*(N+1)
  + ['ssmi_spati']*(N+1) + ['ssmi_arith']*(N+1)

and writes ``new_mask.xlsx``.  Where openpyxl is absent, ``save`` emits true
xlsx via the stdlib zip+XML writer (``tpufusion_torch.io.xlsx``), so the
reference artifact name stays real. Values may be tensors on any device;
they reach the host through ``core.imaging._host``.
"""

from __future__ import annotations

import os

from tpufusion_torch.core.imaging import _host

try:
    import pandas as pd

    _HAS_PANDAS = True
except Exception:  # pragma: no cover
    _HAS_PANDAS = False


class ResultsTable:
    """Accumulates per-batch attack metrics, reference column layout."""

    def __init__(self, n_inputs: int):
        self.n = int(n_inputs)
        n1 = self.n + 1
        self.columns = (
            ["noise"] * self.n
            + ["cri_spati"] * n1 + ["cri_arith"] * n1
            + ["vg_spati"] * n1 + ["vg_arith"] * n1
            + ["ssmi_spati"] * n1 + ["ssmi_arith"] * n1
        )
        self.rows = []

    def add_batch(self, noise, cri_spati, cri_arith, vg_spati, vg_arith,
                  ssmi_spati, ssmi_arith):
        """Each argument is a length-N (noise) or length-N+1 sequence —
        the reference's dict-values concatenation (`interpolation.py:1435`)."""
        row = []
        for vals, want in (
            (noise, self.n), (cri_spati, self.n + 1), (cri_arith, self.n + 1),
            (vg_spati, self.n + 1), (vg_arith, self.n + 1),
            (ssmi_spati, self.n + 1), (ssmi_arith, self.n + 1),
        ):
            vals = [float(v) for v in _host(vals).reshape(-1)]
            if len(vals) != want:
                raise ValueError(f"expected {want} values, got {len(vals)}")
            row += vals
        self.rows.append(row)

    def to_dataframe(self):
        if not _HAS_PANDAS:
            raise RuntimeError("pandas unavailable")
        return pd.DataFrame(self.rows, columns=self.columns)

    def save(self, path: str) -> str:
        """Write the table; ``path`` may end in .xlsx (reference name,
        `interpolation.py:1451`) — pandas/openpyxl when available, else the
        stdlib zip+XML writer.  Returns the path actually written."""
        ext = os.path.splitext(path)[1]
        if ext == ".xlsx":
            try:
                self.to_dataframe().to_excel(path, index=False)
            except Exception:
                from tpufusion_torch.io.xlsx import write_xlsx

                write_xlsx(path, self.columns, self.rows)
            return path
        if _HAS_PANDAS:
            self.to_dataframe().to_csv(path, index=False)
        else:  # stdlib fallback
            with open(path, "w") as f:
                f.write(",".join(self.columns) + "\n")
                for row in self.rows:
                    f.write(",".join(str(v) for v in row) + "\n")
        return path
