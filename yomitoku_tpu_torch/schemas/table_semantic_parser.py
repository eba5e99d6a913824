"""Result schemas for table semantic parsing.

Public contract — field names/shapes mirror the reference
(yomitoku/schemas/table_semantic_parser.py:48-794): cells keyed by id,
key-value items, grid representations, search APIs (by id / bbox / query /
adjacency), view/export facades, and the template system.

The port's copy of ``yomitoku_tpu/schemas/table_semantic_parser.py``, line for line.
"""

import json
import os
import re
from collections import defaultdict
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import Field, PrivateAttr, conlist

from ..base import BaseSchema
from ..reading_order import prediction_reading_order
from ..utils.misc import (
    calc_overlap_ratio,
    is_bottom_adjacent,
    is_contained,
    is_right_adjacent,
    quad_to_xyxy,
)
from . import Element, ParagraphSchema, WordPrediction

MatchPolicy = Literal["cell_id", "bbox"]

Box = conlist(int, min_length=4, max_length=4)


def make_unique_all(seq):
    """Append disambiguating indices to duplicate keys (reference :26)."""
    counter = defaultdict(int)
    result = []
    for x in seq:
        key = tuple(x)
        result.append(x + [counter[key]])
        counter[key] += 1
    for res, x in zip(result, seq):
        if counter[tuple(x)] == 1:
            res.pop()
    return result


def normalize(text: str) -> str:
    """Strip half/full-width spaces."""
    return re.sub(r"[ 　]", "", text)


class TemplateMetaSchema(BaseSchema):
    template_version: str = Field("beta", description="Template schema version")
    template_id: Optional[str] = Field(None, description="Human-readable template id")
    notes: Optional[str] = Field(None, description="Notes for template editors")
    match_policy: MatchPolicy = Field("cell_id", description="How to match cells")


class CellSchema(BaseSchema):
    meta: Dict[str, Any] = Field(
        default_factory=dict,
        description="Additional metadata for template/semantics",
    )
    contents: Union[str, None] = Field(..., description="Text content of the cell")
    role: Union[str, None] = Field(
        ..., description="Role of the cell, e.g., ['cell', 'header', 'empty', 'group']"
    )
    id: Union[str, None] = Field(..., description="Unique identifier of the cell")
    box: Box = Field(..., description="Bounding box [x1, y1, x2, y2]")
    row: Union[int, None] = Field(..., description="Row index of the cell")
    col: Union[int, None] = Field(..., description="Column index of the cell")
    row_span: Union[int, None] = Field(..., description="Rows spanned by the cell")
    col_span: Union[int, None] = Field(..., description="Columns spanned by the cell")


class TableDetectorSchema(BaseSchema):
    id: Union[str, None] = Field(..., description="Unique identifier")
    box: Box = Field(..., description="Bounding box [x1, y1, x2, y2]")
    role: Union[str, None] = Field(..., description="Role of the table element")
    cells: List[CellSchema] = Field(..., description="List of detected table cells")


class KvItemSchema(BaseSchema):
    id: Union[str, None] = Field(..., description="Unique identifier of the kv item")
    key: Union[str, List[str]] = Field(..., description="Key cell id(s)")
    value: str = Field(..., description="Value cell id")
    box: Union[Box, None] = Field(
        None, description="Bounding box of the key-value item"
    )


class TableGridSchema(BaseSchema):
    id: Union[str, None] = Field(..., description="Unique identifier of the grid")
    box: Box = Field(..., description="Bounding box [x1, y1, x2, y2]")
    n_row: int = Field(..., description="Number of rows")
    n_col: int = Field(..., description="Number of columns")
    col_headers: List[List[str]] = Field(
        ..., description="2D array of column-header cell ids"
    )
    data: List[List[Union[str, None]]] = Field(
        ..., description="2D array of grid data cell ids"
    )


class TableSemanticContentsSchema(BaseSchema):
    id: Optional[str] = Field(None, description="Unique identifier of the table")
    style: str = Field(
        ..., description="Border style, e.g., ['border', 'borderless']"
    )
    box: Box = Field(..., description="Bounding box [x1, y1, x2, y2]")
    cells: Dict[str, CellSchema] = Field(..., description="Cells keyed by cell_id")
    kv_items: List[KvItemSchema] = Field(..., description="Extracted kv items")
    grids: List[TableGridSchema] = Field(..., description="Grid representations")

    _export: "TableSemanticContentsExport" = PrivateAttr()
    _view: "TableSemanticContentsView" = PrivateAttr()

    def __init__(self, **data):
        super().__init__(**data)
        self._view = TableSemanticContentsView(self)
        self._export = TableSemanticContentsExport(self)

    @property
    def view(self) -> "TableSemanticContentsView":
        return self._view

    @property
    def export(self) -> "TableSemanticContentsExport":
        return self._export

    def safe_contents(self, cell_id: str, ignore_space=True) -> str:
        c = self.cells.get(cell_id)
        contents = (c.contents or "") if c is not None else ""
        return contents.replace(" ", "") if ignore_space else contents

    def find_cell_by_id(self, cell_id: str) -> Optional[CellSchema]:
        return self.cells.get(str(cell_id))

    def _non_group_cells(self):
        return (c for c in self.cells.values() if c.role != "group")

    def search_cells_by_bbox(self, box: List[int]) -> List[CellSchema]:
        return [
            c for c in self._non_group_cells()
            if is_contained(box, c.box, threshold=0.5)
        ]

    def search_cells_by_query(self, query: str) -> List[CellSchema]:
        q = normalize(query)
        return [
            c for c in self._non_group_cells()
            if c.contents and q in normalize(c.contents)
        ]

    def _search_adjacent(self, key: str, predicate) -> List[CellSchema]:
        query_cells = self.search_cells_by_query(key)
        if not query_cells:
            return []
        out = []
        for cell in self._non_group_cells():
            for qc in query_cells:
                if predicate(qc, cell):
                    out.append(cell)
        return out

    def search_cells_below_key_text(self, key: str) -> List[CellSchema]:
        return self._search_adjacent(
            key, lambda q, c: is_bottom_adjacent(q.box, c.box)
        )

    def search_cells_upper_key_text(self, key: str) -> List[CellSchema]:
        return self._search_adjacent(
            key, lambda q, c: is_bottom_adjacent(c.box, q.box)
        )

    def search_cells_right_of_key_text(self, key: str) -> List[CellSchema]:
        return self._search_adjacent(
            key, lambda q, c: is_right_adjacent(q.box, c.box)
        )

    def search_cells_left_of_key_text(self, key: str) -> List[CellSchema]:
        return self._search_adjacent(
            key, lambda q, c: is_right_adjacent(c.box, q.box)
        )

    def search_kv_items_by_key(self, key: str) -> List[dict]:
        q = normalize(key)
        results: List[dict] = []
        for kv_item in self.kv_items:
            key_cells = [self.cells.get(k) for k in kv_item.key]
            value_cell = self.cells.get(kv_item.value)
            key_text = "".join((kc.contents or "") for kc in key_cells if kc)
            if q in normalize(key_text):
                results.append({"key": key_cells, "value": value_cell})
        for grid in self.grids:
            for i, col in enumerate(grid.col_headers):
                col_cells = [self.cells.get(ck) for ck in col]
                col_text = "".join(
                    (c.contents or "") for c in col_cells if c
                )
                if q in normalize(col_text):
                    for row in grid.data:
                        if i < len(row):
                            results.append(
                                {"key": col_cells, "value": self.cells.get(row[i])}
                            )
        return results

    def find_table_by_column_name(self, queries) -> "TableSemanticContentsSchema":
        grids = []
        for grid in self.grids:
            filtered = self.filter_columns_ignore_space(grid, queries)
            if filtered is not None:
                grids.append(filtered)
        return TableSemanticContentsSchema(
            id=self.id, box=self.box, style=self.style, cells=self.cells,
            grids=grids, kv_items=self.kv_items,
        )

    def filter_columns_ignore_space(self, grid, queries):
        norm_queries = [normalize(q) for q in queries]
        result = {"id": grid.id, "data": []}
        col_headers_filtered = defaultdict(int)
        for row in grid.data:
            filtered_row = []
            for i, cell in enumerate(row):
                key_contents = [
                    (self.cells.get(rk).contents or "")
                    if self.cells.get(rk)
                    else ""
                    for rk in grid.col_headers[i]
                ]
                nk = normalize("".join(key_contents))
                if any(q in nk for q in norm_queries):
                    filtered_row.append(cell)
                    col_headers_filtered[tuple(grid.col_headers[i])] += 1
            if filtered_row:
                result["data"].append(filtered_row)
                result["n_col"] = len(filtered_row)
        result["n_row"] = len(result["data"])
        result["col_headers"] = [list(k) for k in col_headers_filtered]
        result["box"] = grid.box
        return TableGridSchema(**result) if result["data"] else None


class TableSemanticContentsExport:
    def __init__(self, table: TableSemanticContentsSchema):
        self.table = table

    def to_json(self, out_path, merge_values=False, separator="\n"):
        dirname = os.path.dirname(out_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        table_contents = {
            "kv_items": self.table.view.kv_items_to_dict(
                merge_values=merge_values, separator=separator
            ),
            "grids": self.table.view.grids_to_dict(),
        }
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(table_contents, f, ensure_ascii=False, indent=4)

    def grids_to_csv(self, out_path, columns=None, ignore_space=True):
        table_contents = self.table
        if columns is not None:
            table_contents = self.table.find_table_by_column_name(queries=columns)
        dirname = os.path.dirname(out_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        csvs = []
        for table_grid in table_contents.grids:
            rows = [
                [table_contents.safe_contents(cid, ignore_space) for cid in row]
                for row in table_grid.data
            ]
            basename = out_path.rsplit(".", 1)[0]
            with open(f"{basename}_{table_grid.id}.csv", "w", encoding="utf-8") as f:
                for row in rows:
                    f.write(",".join(row) + "\n")
            csvs.append(rows)
        return csvs

    def grids_to_json(self, out_path):
        grids = self.table.view.grids_to_dict()
        dirname = os.path.dirname(out_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(grids, f, ensure_ascii=False, indent=4)
        return grids

    def kv_items_to_json(self, out_path, merge_values=False, separator="\n"):
        kv_items = self.table.view.kv_items_to_dict(
            merge_values=merge_values, separator=separator
        )
        dirname = os.path.dirname(out_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(kv_items, f, ensure_ascii=False, indent=4)
        return kv_items


class TableSemanticContentsView:
    def __init__(self, table: TableSemanticContentsSchema):
        self.table = table

    def kv_items_to_dict(self, merge_values=False, separator="\n") -> dict:
        t = self.table
        parsed = {}
        keys = [[t.safe_contents(i) for i in kv.key] for kv in t.kv_items]
        vals = [t.safe_contents(kv.value) for kv in t.kv_items]

        if not merge_values:
            keys = make_unique_all(keys)
            for k, v in zip(keys, vals):
                parsed["_".join(map(str, k))] = str(v)
            return parsed

        grouped = defaultdict(list)
        for kv, k, v in zip(t.kv_items, keys, vals):
            grouped["_".join(map(str, k))].append((v, t.cells.get(kv.value)))
        for key_str, items in grouped.items():
            if len(items) == 1:
                parsed[key_str] = str(items[0][0])
                continue
            with_boxes = [(v, c) for v, c in items if c is not None]
            if with_boxes:
                boxes = [c.box for _, c in with_boxes]
                x_spread = max(b[0] for b in boxes) - min(b[0] for b in boxes)
                y_spread = max(b[1] for b in boxes) - min(b[1] for b in boxes)
                with_boxes.sort(
                    key=lambda x: x[1].box[1] if y_spread >= x_spread else x[1].box[0]
                )
                parsed[key_str] = separator.join(str(v) for v, _ in with_boxes)
            else:
                parsed[key_str] = separator.join(str(v) for v, _ in items)
        return parsed

    def grids_to_dict(self, ignore_space=True) -> list:
        t = self.table
        results = []
        for grid in t.grids:
            row_record_list = []
            for row in grid.data:
                parsed_row = {}
                seen = set()
                col_key_list, value_list = [], []
                for i, cell in enumerate(row):
                    if cell in grid.col_headers[i]:
                        continue
                    if cell in seen:
                        continue
                    col_key_list.append(
                        [t.safe_contents(k, ignore_space) for k in grid.col_headers[i]]
                    )
                    value_list.append(t.safe_contents(cell, ignore_space))
                    seen.add(cell)
                col_key_list = make_unique_all(col_key_list)
                for ck, v in zip(col_key_list, value_list):
                    parsed_row["_".join(map(str, ck))] = v
                if parsed_row:
                    row_record_list.append(parsed_row)
            results.append({"id": grid.id, "rows": row_record_list})
        return results


class CellTemplateSchema(BaseSchema):
    id: Optional[str] = Field(None, description="Cell id for matching")
    box: Optional[Box] = Field(None, description="Cell bbox for matching")
    role: Optional[str] = Field(None, description="Role override")
    contents: Optional[str] = Field(None, description="Contents override")


class TableSemanticContentsTemplateSchema(BaseSchema):
    id: Optional[str] = Field(None, description="Table id (optional)")
    style: Optional[str] = Field(None, description="Border style (optional)")
    box: Box = Field(..., description="Bounding box [x1, y1, x2, y2]")
    cells: Dict[str, CellTemplateSchema] = Field(
        default_factory=dict, description="Template cells keyed by cell_id"
    )
    kv_items: Optional[List[KvItemSchema]] = Field(
        None, description="Optional KV items override"
    )
    grids: Optional[List[TableGridSchema]] = Field(
        None, description="Optional grids override"
    )


class TableSemanticParserTemplateSchema(BaseSchema):
    meta: TemplateMetaSchema = Field(..., description="Template metadata")
    tables: List[TableSemanticContentsTemplateSchema] = Field(
        ..., description="List of table templates"
    )

    def find_table_by_id(self, table_id: str):
        for table in self.tables:
            if table.id == str(table_id):
                return table


class TableSemanticParserSchema(BaseSchema):
    tables: List[TableSemanticContentsSchema] = Field(
        ..., description="List of tables with semantic information"
    )
    paragraphs: List[Element] = Field(..., description="Recognized paragraphs")
    words: List[WordPrediction] = Field(..., description="Recognized words")

    def search_words_by_position(self, bbox) -> str:
        words = []
        for word in self.words:
            word_box = quad_to_xyxy(word.points)
            if is_contained(bbox, word_box, threshold=0.5):
                words.append(
                    ParagraphSchema(
                        box=word_box, contents=word.content,
                        direction=word.direction, role=None, order=None,
                    )
                )
        dirs = [w.direction for w in words]
        element_direction = (
            "horizontal"
            if dirs.count("horizontal") > dirs.count("vertical")
            else "vertical"
        )
        order = "left2right" if element_direction == "horizontal" else "right2left"
        words = prediction_reading_order(words, order)
        words = sorted(words, key=lambda x: x.order)
        return "".join(w.contents for w in words)

    @classmethod
    def load_json(cls, json_path: str) -> "TableSemanticParserSchema":
        with open(json_path, "r", encoding="utf-8") as f:
            return cls.model_validate(json.load(f))

    def to_csv(self, outdir):
        for table in self.tables:
            table.export.grids_to_csv(out_path=f"{outdir}/table_{table.id}.csv")

    def to_dict(self, merge_values=False, separator="\n"):
        return {
            table.id: {
                "kv_items": table.view.kv_items_to_dict(
                    merge_values=merge_values, separator=separator
                ),
                "grids": table.view.grids_to_dict(),
            }
            for table in self.tables
        }

    def find_table_by_id(self, table_id: str):
        for table in self.tables:
            if table.id == str(table_id):
                return table

    def find_table_by_position(self, box: List[int]):
        ratios = [calc_overlap_ratio(box, t.box)[0] for t in self.tables]
        if not ratios:
            return None
        max_idx = ratios.index(max(ratios))
        return self.tables[max_idx] if ratios[max_idx] > 0.5 else None

    def search_kv_items_by_key(self, key: str) -> List[dict]:
        results = []
        for table in self.tables:
            results.extend(table.search_kv_items_by_key(key))
        return results

    def load_template_json(self, template_path: str):
        with open(template_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        template = TableSemanticParserTemplateSchema.model_validate(data)
        return apply_table_template(self, template)

    def save_template_json(
        self, out_path: str, include_kv: bool = True, include_grids: bool = True
    ):
        template_tables = []
        for t in self.tables:
            tmp_cells = {
                str(cid): CellTemplateSchema(
                    id=str(c.id) if c.id is not None else str(cid),
                    box=list(c.box) if c.box is not None else None,
                    role=c.role,
                    contents=c.contents,
                )
                for cid, c in t.cells.items()
                if c.role != "group"
            }
            template_tables.append(
                TableSemanticContentsTemplateSchema(
                    id=t.id, style=t.style, box=list(t.box), cells=tmp_cells,
                    kv_items=t.kv_items if include_kv else None,
                    grids=t.grids if include_grids else None,
                )
            )
        template = TableSemanticParserTemplateSchema(
            meta=TemplateMetaSchema(), tables=template_tables
        )
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(
                template.model_dump(exclude_none=True), f,
                ensure_ascii=False, indent=4,
            )


def _match_cell(table, tcell, policy="cell_id"):
    if policy == "cell_id":
        if not tcell.id:
            return None
        return table.cells.get(str(tcell.id))
    if policy == "bbox":
        if not tcell.box:
            return None
        candidates = table.search_cells_by_bbox(list(tcell.box))
        return candidates[0] if candidates else None
    return None


def apply_table_template(tables, tmpl):
    """Overlay template roles/contents/kv/grids onto matched tables
    (reference :767)."""
    policy = getattr(tmpl.meta, "match_policy", "cell_id")
    for tmp_table in tmpl.tables:
        table = tables.find_table_by_position(tmp_table.box)
        if table is None:
            continue
        for tcell in tmp_table.cells.values():
            cell = _match_cell(table, tcell, policy=policy)
            if cell is None:
                continue
            if tcell.role is not None:
                cell.role = tcell.role
            if tcell.contents is not None:
                cell.contents = tcell.contents
        if tmp_table.kv_items is not None:
            table.kv_items = tmp_table.kv_items
        if tmp_table.grids is not None:
            table.grids = tmp_table.grids
    return tables
