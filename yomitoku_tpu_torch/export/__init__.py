from .export_csv import convert_csv, export_csv, save_csv
from .export_html import convert_html, export_html, save_html
from .export_json import convert_json, export_json, save_json
from .export_markdown import convert_markdown, export_markdown, save_markdown

__all__ = [
    "export_html",
    "export_markdown",
    "export_csv",
    "export_json",
    "save_html",
    "save_markdown",
    "save_csv",
    "save_json",
    "convert_html",
    "convert_markdown",
    "convert_csv",
    "convert_json",
]
