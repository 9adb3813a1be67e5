"""Feature extraction's host pieces (the port of
``crct_tpu/detector/extract.py``). Only :func:`resolve_depth`, which the
detector trainer needs, is ported so far; the extractor itself waits for
the extraction slice."""

from __future__ import annotations

from typing import Any, Dict


def resolve_depth(cli_depth: int, meta: Dict[str, Any], dataset: str,
                  weights_path: str = "") -> int:
    """The ResNet trunk depth: an explicit CLI value must agree with the
    weights file's recorded or derived depth (a mismatch would transfer
    only the matching prefix and leave deeper blocks random), else the
    file's depth wins, else the dataset rule (R101 for figure_qa, reference
    frcnn.py:137-155)."""
    file_depth = meta.get("depth")
    if cli_depth and file_depth and cli_depth != file_depth:
        raise ValueError(
            f"--depth {cli_depth} does not match the R{file_depth} trunk "
            f"recorded in {weights_path!r}; loading would transfer only "
            f"the matching prefix and leave deeper blocks randomly "
            f"initialized. Drop --depth (it is derived from the weights) "
            f"or point at matching weights.")
    return cli_depth or file_depth or (101 if dataset == "figure_qa" else 50)
