"""Distillation codes table.

Loads the vendored ``CodesTable_All_Expanded.xlsx`` (reference data,
``sequence_optimisation.py:56``) with a stdlib zip+XML reader — the image has
no openpyxl. Rows are (n, k, d, CodeType, Basis).
"""

from __future__ import annotations

import os
import zipfile
from functools import lru_cache
from xml.etree import ElementTree as ET

_DIR = os.path.join(os.path.dirname(os.path.realpath(__file__)), "code_data")
_XLSX = os.path.join(_DIR, "CodesTable_All_Expanded.xlsx")
_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _read_xlsx_rows(path: str) -> list[list[str]]:
    with zipfile.ZipFile(path) as z:
        shared = [
            el.findtext(".//m:t", default="", namespaces=_NS)
            for el in ET.fromstring(z.read("xl/sharedStrings.xml")).findall("m:si", _NS)
        ]
        sheet = ET.fromstring(z.read("xl/worksheets/sheet1.xml"))
    rows = []
    for row in sheet.findall(".//m:row", _NS):
        vals = []
        for c in row.findall("m:c", _NS):
            v = c.findtext("m:v", default="", namespaces=_NS)
            if c.get("t") == "s" and v != "":
                v = shared[int(v)]
            vals.append(v)
        rows.append(vals)
    return rows


@lru_cache(maxsize=None)
def load_codes_table(path: str | None = None) -> list[tuple]:
    """All codes as (n, k, d, code_type, basis) tuples, header skipped."""
    rows = _read_xlsx_rows(path or _XLSX)
    header, *body = rows
    assert header[:4] == ["n", "k", "d", "CodeType"], header
    out = []
    for r in body:
        if not r or r[0] == "":
            continue
        n, k, d = int(r[0]), int(r[1]), int(r[2])
        code_type = r[3]
        basis = r[4] if len(r) > 4 else ""
        out.append((n, k, d, code_type, basis))
    return out


def filtered_codes(max_rep_code: int = 12, max_quantum_code: float = float("inf")):
    """(classical_codes, quantum_codes) filtered per the reference rules:
    classical → only [n,1,n] repetition with n <= max_rep_code; quantum →
    n <= max_quantum_code and n > 1; quantum sorted by (n, -k, -d)."""
    max_rep_code = min(12, max_rep_code)
    cl, q = [], []
    for n, k, d, ctype, basis in load_codes_table():
        if ctype == "Classical":
            if n == d and n <= max_rep_code:
                cl.append((n, k, d, ctype, basis))
        elif ctype == "Quantum":
            if n <= max_quantum_code and n != 1:
                q.append((n, k, d, ctype, basis))
    q.sort(key=lambda c: (c[0], -c[1], -c[2]))
    return cl, q
