"""Minimal xlsx (SpreadsheetML) writer/reader on the stdlib only (a copy
of ``wsss_tpu/eval/xlsx.py``).

The reference emits its per-class metric tables as ``df.to_excel(...)``
xlsx files (01_train/utilities.py:181-193, 03a_sec-dsrg/model.py:740-745,
03c_hsn/demo.py:233-238) and `scripts/extract_eval.py:20-99` reads them
back with ``pd.read_excel``, selecting the ``IoU`` value of the row whose
``Class`` column equals ``'Mean'``.  This module implements the subset of
ECMA-376 needed for that interop without openpyxl:

  * :func:`write_xlsx` — one worksheet from a list of rows (str / number /
    None cells), inline strings, no shared-string table.
  * :func:`write_table_xlsx` — the exact ``df.to_excel`` cell layout
    (blank index header + integer index column) so the reference's
    pandas-based ``extract_eval`` parses our files unchanged.
  * :func:`read_xlsx` — first worksheet back to a list of rows; handles
    inline strings, shared strings (what pandas/openpyxl writers emit),
    and numeric cells, so ``extract_eval`` can aggregate
    reference-produced xlsx outputs alongside csv outputs.
  * :func:`read_table_xlsx` — inverse of :func:`write_table_xlsx`:
    ``{column_name: [values]}`` with the index column dropped.
"""
from __future__ import annotations

import math
import os
import re
import zipfile
from typing import Dict, List, Optional, Sequence, Union
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

Cell = Union[str, float, int, None]

_NS = 'http://schemas.openxmlformats.org/spreadsheetml/2006/main'
_NS_PKG_REL = ('http://schemas.openxmlformats.org/package/2006/'
               'relationships')
_NS_DOC_REL = ('http://schemas.openxmlformats.org/officeDocument/2006/'
               'relationships')

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
    'content-types">'
    '<Default Extension="rels" ContentType="application/'
    'vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
    '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
    'worksheet+xml"/>'
    '</Types>')

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    f'<Relationships xmlns="{_NS_PKG_REL}">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/officeDocument" '
    'Target="xl/workbook.xml"/>'
    '</Relationships>')

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    f'<Relationships xmlns="{_NS_PKG_REL}">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/worksheet" '
    'Target="worksheets/sheet1.xml"/>'
    '</Relationships>')


def _col_name(idx: int) -> str:
    """0-based column index -> spreadsheet letters (0->A, 26->AA)."""
    name = ''
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord('A') + rem) + name
    return name


def _col_index(ref: str) -> int:
    """Cell reference ('B7') -> 0-based column index."""
    idx = 0
    for ch in ref:
        if not ch.isalpha():
            break
        idx = idx * 26 + (ord(ch.upper()) - ord('A') + 1)
    return idx - 1


def _cell_xml(ref: str, value: Cell) -> str:
    if value is None:
        return ''
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, (int, float)):
        # numeric cells cannot hold NaN/inf in SpreadsheetML (<v>nan</v>
        # is invalid and breaks Excel/pandas) — write a blank cell, the
        # same thing df.to_excel does; ADP's no-epsilon IoU yields NaN
        # for absent classes (03c_hsn/demo.py:233-238)
        if isinstance(value, float) and not math.isfinite(value):
            return ''
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    return (f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
            f'{escape(str(value))}</t></is></c>')


def write_xlsx(path: str, rows: Sequence[Sequence[Cell]],
               sheet_name: str = 'Sheet1') -> None:
    """Write `rows` as a single-worksheet xlsx file."""
    body = []
    for r, row in enumerate(rows):
        cells = ''.join(_cell_xml(f'{_col_name(c)}{r + 1}', v)
                        for c, v in enumerate(row))
        body.append(f'<row r="{r + 1}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<worksheet xmlns="{_NS}"><sheetData>'
        + ''.join(body) + '</sheetData></worksheet>')
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<workbook xmlns="{_NS}" xmlns:r="{_NS_DOC_REL}"><sheets>'
        f'<sheet name="{escape(sheet_name)}" sheetId="1" r:id="rId1"/>'
        '</sheets></workbook>')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as z:
        z.writestr('[Content_Types].xml', _CONTENT_TYPES)
        z.writestr('_rels/.rels', _ROOT_RELS)
        z.writestr('xl/workbook.xml', workbook)
        z.writestr('xl/_rels/workbook.xml.rels', _WORKBOOK_RELS)
        z.writestr('xl/worksheets/sheet1.xml', sheet)


def write_table_xlsx(path: str, columns: Dict[str, Sequence[Cell]]) -> None:
    """`df.to_excel`-layout table: blank index header cell, column names,
    then one integer index + values per row — the byte layout the
    reference's `pd.read_excel` consumers expect."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    rows: List[List[Cell]] = [[None] + names]
    for i in range(n):
        rows.append([i] + [columns[name][i] for name in names])
    write_xlsx(path, rows)


def _sheet_path(z: zipfile.ZipFile) -> str:
    """First sheet's worksheet part, resolved through workbook rels."""
    try:
        wb = ET.fromstring(z.read('xl/workbook.xml'))
        first = wb.find(f'{{{_NS}}}sheets/{{{_NS}}}sheet')
        rid = first.get(f'{{{_NS_DOC_REL}}}id')
        rels = ET.fromstring(z.read('xl/_rels/workbook.xml.rels'))
        for rel in rels:
            if rel.get('Id') == rid:
                target = rel.get('Target').lstrip('/')
                if not target.startswith('xl/'):
                    target = 'xl/' + target
                return target
    except (KeyError, AttributeError, ET.ParseError):
        pass
    return 'xl/worksheets/sheet1.xml'


def read_xlsx(path: str) -> List[List[Cell]]:
    """First worksheet as a dense list of rows (None for absent cells)."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if 'xl/sharedStrings.xml' in z.namelist():
            sst = ET.fromstring(z.read('xl/sharedStrings.xml'))
            for si in sst.iter(f'{{{_NS}}}si'):
                shared.append(''.join(t.text or ''
                                      for t in si.iter(f'{{{_NS}}}t')))
        sheet = ET.fromstring(z.read(_sheet_path(z)))
        rows: List[List[Cell]] = []
        for row in sheet.iter(f'{{{_NS}}}row'):
            out: List[Cell] = []
            for c in row.iter(f'{{{_NS}}}c'):
                ref = c.get('r')
                col = _col_index(ref) if ref else len(out)
                while len(out) <= col:
                    out.append(None)
                ctype = c.get('t', 'n')
                v = c.find(f'{{{_NS}}}v')
                if ctype == 'inlineStr':
                    out[col] = ''.join(t.text or ''
                                       for t in c.iter(f'{{{_NS}}}t'))
                elif ctype == 's':
                    out[col] = shared[int(v.text)] if v is not None else ''
                elif ctype == 'str':
                    out[col] = v.text if v is not None else ''
                elif v is not None and v.text is not None:
                    txt = v.text
                    out[col] = float(txt) if re.search(
                        r'[.eE]', txt) else int(txt)
            rows.append(out)
        return rows


def read_table_xlsx(path: str) -> Dict[str, List[Cell]]:
    """Inverse of :func:`write_table_xlsx` (drops the index column).
    Handles tables written by this module and by pandas `to_excel`."""
    rows = read_xlsx(path)
    if not rows:
        return {}
    header = rows[0]
    width = max(len(r) for r in rows)
    start = 1 if (header and (header[0] is None or header[0] == '')) else 0
    table: Dict[str, List[Cell]] = {}
    for col in range(start, width):
        name = header[col] if col < len(header) else None
        if name is None:
            continue
        table[str(name)] = [r[col] if col < len(r) else None
                            for r in rows[1:]]
    return table


def table_mean_value(path: str, key_col: str = 'Class',
                     key: str = 'Mean',
                     value_col: str = 'IoU') -> Optional[float]:
    """extract_eval.py:20-25 semantics: the `value_col` entry of the row
    whose `key_col` equals `key`; None if absent/unreadable."""
    try:
        table = read_table_xlsx(path)
        keys = table.get(key_col)
        vals = table.get(value_col)
        if keys is None or vals is None:
            return None
        for k, v in zip(keys, vals):
            if k == key and v is not None:
                return float(v)
    except (OSError, zipfile.BadZipFile, ET.ParseError, ValueError):
        return None
    return None
