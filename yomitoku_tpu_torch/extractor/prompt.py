"""Prompt builder for LLM-based structured field extraction.

The emitted text is a behavioral contract shared with the reference
(yomitoku/extractor/prompt.py): the strict-JSON system prompt and a user
message with Paragraphs / Tables / Extraction Schema / Response Format
sections, where every piece of content carries its [cell_id,...] so the
LLM can cite sources.  The builder here renders those sections through a
small section registry; each renderer yields lines.

The port's copy of ``yomitoku_tpu/extractor/prompt.py``, line for line.
"""

import json
from typing import Dict, List, Optional

from .schema import ExtractionSchema

SYSTEM_PROMPT = """\
You are a document data extraction assistant.
You receive OCR-analyzed document data and extract information according to a schema.
Respond with valid JSON only. No explanation outside JSON.

CRITICAL RULES:
1. Return a JSON object with a single key "results" containing an array.
2. The array MUST have exactly one entry per schema field, in the same order as the schema.
3. Each entry MUST have these exact keys: "name", "value", "raw_text", "cell_ids", "confidence", "source".
4. For structure=kv fields:
   - "value" MUST be a plain string (e.g. "東京都渋谷区"). NEVER an object or array.
   - "cell_ids" is a list of IDs where the value was found (e.g. ["c5"] or ["p0"] or ["w3"]).
5. For structure=table fields:
   - "value" MUST be a list of row objects. Each row has column names as keys.
   - Each column value is an object with "value" (string) and "cell_ids" (list).
6. "confidence": "high", "medium", or "low".
7. "source": one of "kv", "grid", "cell_search", "paragraph", "word".
8. If a value cannot be found, return "value": "", "cell_ids": [], "confidence": "low", "source": "not_found".
9. Cell IDs are listed in brackets [id1,id2,...] at the end of each entry. Use these IDs directly in your response.
10. For structure=table: each column entry shows "header: value [id1,id2,...]". Use the value text as "value" and the bracketed IDs as "cell_ids".
"""


def _flat(text) -> str:
    return (text or "").replace("\n", " ")


def _cell_text(table, cell_id: str) -> str:
    cell = table.cells.get(cell_id)
    return _flat(cell.contents) if cell is not None else ""


def _paragraph_lines(semantic_info, _schema):
    for i, p in enumerate(semantic_info.paragraphs):
        pid = p.id or f"p{i}"
        yield (
            f"  {pid}: contents={_flat(p.contents)!r}, "
            f"role={(p.role or '')!r}, box={list(p.box)}"
        )


def _kv_lines(table, cited):
    yield "KV Items:"
    for kv in table.kv_items:
        key_ids = kv.key if isinstance(kv.key, list) else [kv.key]
        cited.update(key_ids)
        cited.add(kv.value)
        key_text = "".join(_cell_text(table, k) for k in key_ids)
        ids = ",".join(list(key_ids) + [kv.value])
        yield f"  - {key_text}: {_cell_text(table, kv.value)} [{ids}]"


def _grid_lines(table, grid, cited):
    yield f"Grid {grid.id or 'g?'}:"
    headers = []
    for col_ids in grid.col_headers:
        headers.append("".join(_cell_text(table, c) for c in col_ids))
        cited.update(col_ids)
    for row_idx, row in enumerate(grid.data):
        # fold columns sharing a header text into one entry per row
        groups: Dict[str, list] = {}
        for col_idx, cid in enumerate(row):
            title = headers[col_idx] if col_idx < len(headers) else "?"
            slot = groups.setdefault(title, [])
            if cid is not None:
                slot.append(cid)
                cited.add(cid)
        cols = [
            f"{title}: {''.join(_cell_text(table, c) for c in ids)}"
            f" [{','.join(ids)}]"
            for title, ids in groups.items()
        ]
        yield f"  Row {row_idx}: {' | '.join(cols)}"


def _table_lines(semantic_info, _schema, table_id: Optional[str] = None):
    first = True
    for table in semantic_info.tables:
        if table_id and table.id != table_id:
            continue
        if not first:
            yield ""
        first = False
        yield f"--- Table {table.id} (style={table.style}) ---"
        cited = set()
        if table.kv_items:
            yield from _kv_lines(table, cited)
        for grid in table.grids:
            yield from _grid_lines(table, grid, cited)
        orphans = [
            f"  {cid}: contents={_flat(cell.contents)!r}, role={cell.role!r}"
            for cid, cell in table.cells.items()
            if cell.role != "group" and cid not in cited
        ]
        if orphans:
            yield "Unassigned Cells:"
            yield from orphans


def _schema_lines(_semantic_info, schema: ExtractionSchema):
    yield "Fields to extract:"
    for field in schema.fields:
        desc = field.description or field.name
        if field.structure == "table":
            cols = ""
            if field.columns:
                cols = ", columns=[{}]".format(
                    ", ".join(f"{c.name}(type={c.type})" for c in field.columns)
                )
            yield f"  - {field.name}: {desc} (structure=table{cols})"
        else:
            yield f"  - {field.name}: {desc} (structure=kv, type={field.type})"


def _example_entry(field):
    if field.structure == "table" and field.columns:
        return {
            "name": field.name,
            "value": [
                {c.name: {"value": "...", "cell_ids": ["c0"]} for c in field.columns}
            ],
            "raw_text": "",
            "cell_ids": [],
            "confidence": "high",
            "source": "grid",
        }
    return {
        "name": field.name,
        "value": "extracted text here",
        "raw_text": "original text here",
        "cell_ids": ["c0"],
        "confidence": "high",
        "source": "kv",
    }


def _format_lines(_semantic_info, schema: ExtractionSchema):
    example = {"results": [_example_entry(f) for f in schema.fields]}
    yield (
        "You MUST return JSON in exactly this structure "
        "(one entry per field, same order as schema):\n"
        + json.dumps(example, ensure_ascii=False, indent=2)
    )


def build_messages(
    semantic_info, schema: ExtractionSchema, table_id: Optional[str] = None
) -> List[Dict[str, str]]:
    sections = [
        ("Paragraphs", _paragraph_lines(semantic_info, schema)),
        ("Tables", _table_lines(semantic_info, schema, table_id)),
        ("Extraction Schema", _schema_lines(semantic_info, schema)),
        ("Response Format", _format_lines(semantic_info, schema)),
    ]
    body = "\n\n".join(
        f"## {title}\n" + "\n".join(lines) for title, lines in sections
    )
    return [
        {"role": "system", "content": SYSTEM_PROMPT},
        {"role": "user", "content": body + "\n"},
    ]
