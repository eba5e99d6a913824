"""Rule-based (LLM-free) structured field extraction.

Behavioral contract: yomitoku/extractor/rule_pipeline.py — scalar fields
resolve through a fixed priority ladder (cell_id, bbox, kv-key match,
cell query, paragraph substring, regex over cells/paragraphs/words);
table fields match schema columns against grid column headers.  The
output shape is identical to the LLM pipeline's.

Design here: the ladder is data — a list of (guard attribute, strategy)
pairs walked in order until one lands — and the regex pass scans a
single flattened (id, box, text) corpus instead of three bespoke loops.

The port's copy of ``yomitoku_tpu/extractor/rule_pipeline.py``, line for line.
"""

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.logger import set_logger
from ..utils.misc import calc_overlap_ratio, quad_to_xyxy
from .pipeline import (
    _build_output,
    _build_simple_output,
    _normalize_resolved_fields,
)
from .resolver import ResolvedElement, ResolvedField
from .schema import ExtractionSchema

logger = set_logger(__name__, "INFO")

_SQUASH_SPACES = re.compile(r"[ 　]")


def _squash(text: str) -> str:
    return _SQUASH_SPACES.sub("", text)


def _element(id, box, contents, label=None):
    kw = {"label": label} if label is not None else {}
    return ResolvedElement(id=id, box=list(box), contents=contents, **kw)


def _field(schema, value, raw_text, elements, confidence, source):
    return ResolvedField(
        name=schema.name, value=value, raw_text=raw_text,
        elements=elements, confidence=confidence, source=source,
    )


def _cell_field(schema, cell, source, confidence="high"):
    text = cell.contents or ""
    return _field(
        schema, text, text, [_element(cell.id, cell.box, text)],
        confidence, source,
    )


# --------------------------------------------------------------------
# scalar strategies — each returns a ResolvedField or None
# --------------------------------------------------------------------


def _by_cell_id(info, schema):
    """Exact cell-id lookup across every table."""
    hits = (t.find_cell_by_id(schema.cell_id) for t in info.tables)
    cell = next((c for c in hits if c is not None), None)
    return _cell_field(schema, cell, "cell_id") if cell else None


def _by_bbox(info, schema):
    """First cell overlapping the schema bbox."""
    for table in info.tables:
        found = table.search_cells_by_bbox(schema.bbox)
        if found:
            return _cell_field(schema, found[0], "bbox")
    return None


def _spread_axis(boxes) -> int:
    """1 (sort by y) when the vertical spread of the box origins is at
    least the horizontal spread, else 0."""
    origins = np.asarray([b[:2] for b in boxes], np.float64)
    spread = origins.max(axis=0) - origins.min(axis=0)
    return 1 if spread[1] >= spread[0] else 0


def _by_kv(info, schema):
    """KV items whose key matches the description.  With merge_values,
    every matched value cell joins (sorted along the dominant axis);
    otherwise the first match wins."""
    items = info.search_kv_items_by_key(schema.description)
    if not items:
        return None
    if getattr(schema, "merge_values", False) and len(items) > 1:
        cells = [kv["value"] for kv in items if kv["value"] is not None]
        if cells:
            axis = _spread_axis([c.box for c in cells])
            cells.sort(key=lambda c: c.box[axis])
            text = schema.separator.join(c.contents or "" for c in cells)
            return _field(
                schema, text, text,
                [_element(c.id, c.box, c.contents or "") for c in cells],
                "high", "kv",
            )
        return None
    first = items[0]["value"]
    return _cell_field(schema, first, "kv") if first is not None else None


def _by_cell_query(info, schema):
    """Table-level content query (search_cells_by_query)."""
    for table in info.tables:
        found = table.search_cells_by_query(schema.description)
        if found:
            return _cell_field(schema, found[0], "cell_query",
                               confidence="medium")
    return None


def _by_paragraph(info, schema):
    """Space-insensitive substring match over paragraph text."""
    needle = _squash(schema.description)
    for paragraph in info.paragraphs:
        text = paragraph.contents
        if text and needle in _squash(text):
            return _field(
                schema, text, text,
                [_element(paragraph.id or "p0", paragraph.box, text)],
                "medium", "paragraph",
            )
    return None


def _text_corpus(info):
    """Every searchable (id, box, text) on the page, in match-priority
    order: table cells (group-role and empty cells skipped), paragraphs,
    then raw words."""
    for table in info.tables:
        for cell in table.cells.values():
            if cell.role != "group" and cell.contents:
                yield cell.id, cell.box, cell.contents
    for i, paragraph in enumerate(info.paragraphs):
        if paragraph.contents:
            yield paragraph.id or f"p{i}", paragraph.box, paragraph.contents
    for i, word in enumerate(info.words):
        if word.content:
            yield f"w{i}", quad_to_xyxy(word.points), word.content


def _by_regex(info, schema):
    """First regex hit anywhere in the page corpus; the matched span is
    the value, the host text the raw_text."""
    pattern = re.compile(schema.regex)
    for eid, box, text in _text_corpus(info):
        m = pattern.search(text)
        if m:
            return _field(
                schema, m.group(0), text, [_element(eid, box, text)],
                "high", "regex",
            )
    return None


#: the priority ladder: (schema attribute that must be set, strategy)
_SCALAR_LADDER = (
    ("cell_id", _by_cell_id),
    ("bbox", _by_bbox),
    ("description", _by_kv),
    ("description", _by_cell_query),
    ("description", _by_paragraph),
    ("regex", _by_regex),
)


def _extract_scalar_field(info, schema) -> ResolvedField:
    for guard, strategy in _SCALAR_LADDER:
        if getattr(schema, guard, None):
            hit = strategy(info, schema)
            if hit is not None:
                return hit
    return _field(schema, "", "", [], "low", "not_found")


# --------------------------------------------------------------------
# table fields
# --------------------------------------------------------------------


def _header_matches(table, header_cell_ids, col_schema) -> bool:
    """Does this grid column's header stack satisfy the schema column?
    cell_id beats bbox beats text (description, falling back to name)."""
    if col_schema.cell_id:
        return col_schema.cell_id in header_cell_ids
    if col_schema.bbox:
        return any(
            calc_overlap_ratio(col_schema.bbox, list(cell.box))[0] > 0.5
            for cell in map(table.cells.get, header_cell_ids)
            if cell and cell.box
        )
    needle = col_schema.description or col_schema.name
    stacked = "".join(
        cell.contents or ""
        for cell in map(table.cells.get, header_cell_ids)
        if cell
    )
    return _squash(needle) in _squash(stacked)


def _assign_columns(table, grid, columns) -> Dict[str, List[int]]:
    """grid column -> first matching schema column; returned as
    {schema name: [grid col indices]} in first-match order."""
    col_map: Dict[str, List[int]] = {}
    for col_idx, header_ids in enumerate(grid.col_headers):
        name = next(
            (
                cs.name for cs in columns
                if _header_matches(table, header_ids, cs)
            ),
            None,
        )
        if name is not None:
            col_map.setdefault(name, []).append(col_idx)
    return col_map


def _collect_row(table, row, col_map, elements) -> Optional[dict]:
    """One output record: per schema column, the concatenated cell text
    and contributing cell ids.  Appends drawn cells to ``elements``."""
    record = {}
    for name, col_indices in col_map.items():
        texts, cell_ids = [], []
        for ci in col_indices:
            cid = row[ci] if ci < len(row) else None
            if cid is None:
                continue
            cell_ids.append(cid)
            cell = table.cells.get(cid)
            if cell:
                text = cell.contents or ""
                texts.append(text)
                elements.append(_element(cid, cell.box, text, label=name))
        record[name] = {"value": "".join(texts), "cell_ids": cell_ids}
    return record or None


def _extract_table_field(info, schema) -> ResolvedField:
    if not schema.columns:
        return _field(schema, [], "", [], "low", "not_found")

    records: List[dict] = []
    elements: List[ResolvedElement] = []
    for table in info.tables:
        for grid in table.grids:
            col_map = _assign_columns(table, grid, schema.columns)
            if not col_map:
                continue
            header_ids = {
                cid for stack in grid.col_headers for cid in stack
            }
            for row in grid.data:
                present = [cid for cid in row if cid is not None]
                if present and header_ids.issuperset(present):
                    continue  # pure header row
                record = _collect_row(table, row, col_map, elements)
                if record:
                    records.append(record)

    if records:
        return _field(schema, records, "", elements, "high", "grid")
    return _field(schema, [], "", elements, "low", "not_found")


def run_rule_extraction(
    semantic_info,
    img: np.ndarray,
    schema: ExtractionSchema,
    no_normalize: bool = False,
    visualize: bool = False,
    simple: bool = False,
    outdir: str = "results",
    filename: str = "output",
) -> Dict[str, Any]:
    resolved = [
        (_extract_table_field if f.structure == "table"
         else _extract_scalar_field)(semantic_info, f)
        for f in schema.fields
    ]
    resolved = _normalize_resolved_fields(
        resolved, schema, skip_normalize=no_normalize
    )
    output = _build_simple_output(resolved) if simple else _build_output(resolved)

    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, f"{filename}.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(output, f, ensure_ascii=False, indent=2)
    logger.info(f"Output JSON: {out_path}")

    if visualize:
        from ..utils.misc import save_image
        from .visualizer import extraction_visualizer

        vis_img = extraction_visualizer(img, resolved)
        vis_path = os.path.join(outdir, f"{filename}_extract_vis.jpg")
        save_image(vis_img, vis_path)
        logger.info(f"Visualization: {vis_path}")
    return output
