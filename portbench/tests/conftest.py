import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# the page route the card takes, on the CPU too
os.environ.setdefault("YOMITOKU_TPU_DEVICE_CROPS", "1")
