"""Minimal stdlib ``.xlsx`` writer (copy of ``tpufusion/io/xlsx.py``) —
reference C16 output parity.

The reference writes ``new_mask.xlsx`` via pandas/openpyxl
(`interpolation.py:1451`).  openpyxl is absent
in this environment, so this module emits the file directly: an ``.xlsx``
is a zip archive of a fixed set of SpreadsheetML XML parts, and a
single-sheet numeric table needs only four of them.  Strings are written
as inline strings (no shared-string table), numbers as numeric cells, so
any conforming reader (pandas, Excel, LibreOffice) loads it.
"""

from __future__ import annotations

import math
import numbers
import zipfile
from typing import Iterable, Sequence

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" '
    'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" '
    'Target="xl/workbook.xml"/>'
    "</Relationships>"
)

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
    'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
    '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>'
    "</workbook>"
)

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" '
    'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
    'Target="worksheets/sheet1.xml"/>'
    "</Relationships>"
)


def _col_letter(i: int) -> str:
    """0-based column index -> A1-style letters (0->A, 25->Z, 26->AA)."""
    out = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 26)
        out = chr(ord("A") + r) + out
    return out


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def _cell(ref: str, value) -> str:
    if isinstance(value, bool):  # bool is an int subclass — keep it textual
        return f'<c r="{ref}" t="inlineStr"><is><t>{value}</t></is></c>'
    # numbers.Real admits numpy scalars (np.float32/np.int64 register as
    # Real/Integral) — isinstance(int, float) alone would stringify them
    if isinstance(value, numbers.Integral):
        return f'<c r="{ref}"><v>{int(value)!r}</v></c>'
    if isinstance(value, numbers.Real):
        f = float(value)
        if not math.isfinite(f):  # <v>nan</v> is invalid SpreadsheetML;
            return f'<c r="{ref}"/>'  # blank cell, like pandas.to_excel
        return f'<c r="{ref}"><v>{f!r}</v></c>'
    return (f'<c r="{ref}" t="inlineStr"><is>'
            f"<t>{_esc(str(value))}</t></is></c>")


def _sheet_xml(rows: Iterable[Sequence]) -> str:
    parts = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>',
    ]
    for r, row in enumerate(rows, start=1):
        cells = "".join(
            _cell(f"{_col_letter(c)}{r}", v) for c, v in enumerate(row))
        parts.append(f'<row r="{r}">{cells}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


def write_xlsx(path: str, columns: Sequence, rows: Iterable[Sequence]) -> str:
    """Write a single-sheet xlsx with a header row.  Returns ``path``."""
    sheet = _sheet_xml([list(columns)] + [list(r) for r in rows])
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path


def read_xlsx(path: str):
    """Read back a (simple, sheet1-only) xlsx -> (columns, rows) of floats
    where possible.  Stdlib-only; used by tests and as a pandas-free loader
    for the reference's ``new_mask.xlsx`` artifact."""
    import xml.etree.ElementTree as ET

    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():  # openpyxl-style files
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            shared = ["".join(t.text or "" for t in si.iter(f"{ns}t"))
                      for si in root.iter(f"{ns}si")]
        root = ET.fromstring(z.read("xl/worksheets/sheet1.xml"))
        out = []
        for row in root.iter(f"{ns}row"):
            vals = []
            for c in row.iter(f"{ns}c"):
                # honour the cell's A1 reference: writers that omit empty
                # cells (openpyxl skips None/NaN) must not shift later
                # columns left — place by column index, padding with None
                ref = c.get("r") or ""
                letters = ref.rstrip("0123456789")
                if letters:
                    col = 0
                    for ch in letters:
                        col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
                    col -= 1
                else:
                    col = len(vals)
                while len(vals) < col:
                    vals.append(None)
                t = c.get("t")
                if t == "inlineStr":
                    vals.append("".join(
                        el.text or "" for el in c.iter(f"{ns}t")))
                    continue
                v = c.find(f"{ns}v")
                text = v.text if v is not None else None
                if t == "s":
                    vals.append(shared[int(text)])
                elif text is None:
                    # a present-but-valueless cell (our writer's NaN/inf
                    # blanks) reads back as None — the SAME sentinel as a
                    # cell omitted entirely, not a '' the caller's float()
                    # would choke on
                    vals.append(None)
                else:
                    try:
                        vals.append(float(text))
                    except (TypeError, ValueError):
                        vals.append(text)
            out.append(vals)
    if not out:
        return [], []
    return out[0], out[1:]
