"""The page route of tests/test_torch_table_semantic.py: the port's
CellDetector and TableSemanticParser against the JAX package's unfused
route with YOMITOKU_TPU_DEVICE_CROPS=1 on both sides (one page upload;
the layout resize and the table crops on the device), with that file's
models, page, pins and checks.  Apart from it so that each file's JAX
compilations stay under a minute."""

import pytest

from test_torch_table_semantic import (  # noqa: F401  (fixtures)
    check_cell_detector,
    check_semantic_parser,
    check_uploads,
    parsers,
    pinned,
    unfused,
)


@pytest.fixture(autouse=True)
def page_route(unfused, monkeypatch):  # noqa: F811
    monkeypatch.setenv("YOMITOKU_TPU_DEVICE_CROPS", "1")


@pytest.mark.parametrize("n_tables", [1, 3])
def test_cell_detector_from_page_matches_jax(parsers, n_tables, monkeypatch):  # noqa: F811
    check_cell_detector(parsers, "page", n_tables, monkeypatch)


def test_semantic_parser_from_page_matches_jax(parsers, pinned):  # noqa: F811
    check_semantic_parser(parsers)


def test_page_route_uploads_one_page(parsers, monkeypatch):  # noqa: F811
    check_uploads(parsers, "page", monkeypatch)


def test_one_region_route():
    """The table recognizer and the cell detector crop their regions
    through the one page-route function of table_structure_recognizer."""
    from yomitoku_tpu_torch import table_cell_detector, table_structure_recognizer

    shared = table_structure_recognizer.filtered_regions_from_page
    assert table_cell_detector.filtered_regions_from_page is shared
    assert not hasattr(table_structure_recognizer.TableStructureRecognizer,
                       "_filtered_from_page")
