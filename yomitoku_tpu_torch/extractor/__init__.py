from .pipeline import run_extraction
from .rule_pipeline import run_rule_extraction
from .schema import ExtractionSchema

__all__ = ["ExtractionSchema", "run_extraction", "run_rule_extraction"]
