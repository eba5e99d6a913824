"""Constants (the port's copy of what it uses of yomitoku_tpu/constants.py):
the package root, for resource paths, and the visualisation palette."""

import os

ROOT_DIR = os.path.dirname(os.path.abspath(__file__))

# 22-color visualization palette (RGB).
PALETTE = [
    [255, 0, 0],
    [0, 255, 0],
    [0, 0, 255],
    [255, 255, 0],
    [0, 255, 255],
    [255, 0, 255],
    [128, 0, 0],
    [0, 128, 0],
    [0, 0, 128],
    [255, 128, 0],
    [0, 255, 128],
    [128, 0, 255],
    [128, 255, 0],
    [0, 128, 255],
    [255, 0, 128],
    [255, 128, 128],
    [128, 255, 128],
    [128, 128, 255],
    [255, 255, 128],
    [255, 128, 255],
    [128, 255, 255],
    [128, 128, 128],
]
