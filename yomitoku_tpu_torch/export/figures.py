"""The figure crops that the JSON, CSV, Markdown and HTML exporters save
(the port's copy of yomitoku_tpu/export/figures.py)."""

import os

from ..utils.misc import save_image


def crop_figures(figures, img, out_path, figure_dir="figures"):
    """Crop each figure box out of the page image and save as PNGs.

    Returns the list of relative paths (``figure_dir/<name>.png``).
    """
    if not figures:
        return []
    if img is None:
        raise ValueError("img is required for saving figures")
    paths = []
    save_dir = os.path.join(os.path.dirname(out_path), figure_dir)
    filename = os.path.splitext(os.path.basename(out_path))[0]
    for i, figure in enumerate(figures):
        x1, y1, x2, y2 = map(int, figure.box)
        figure_img = img[y1:y2, x1:x2, :]
        os.makedirs(save_dir, exist_ok=True)
        figure_name = f"{filename}_figure_{i}.png"
        save_image(figure_img, os.path.join(save_dir, figure_name))
        paths.append(f"{figure_dir}/{figure_name}")
    return paths
