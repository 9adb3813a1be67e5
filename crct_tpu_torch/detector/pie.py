"""Pie-chart slice-angle estimation from detector bounding boxes.

The port's copy of ``crct_tpu/detector/pie.py``.

Host-side geometry (reference Detector/feature_extraction/pie_area.py):
slice angles come from arcs of the circle/box intersection; the slice whose
box most nearly coincides with the whole pie's bounding box takes the
residual angle so the angles sum to 2*pi.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

PREVIEW_AREA_THRESHOLD = 450.0


class Point:
    def __init__(self, x, y):
        self.x = float(x)
        self.y = float(y)

    def __repr__(self):
        return f"({self.x}, {self.y})"


def _minibox_arc(x: float, y: float, r: float) -> float:
    """Arc angle subtended by the axis-aligned quarter-box corner at (x, y)
    relative to a circle of radius r centered at the origin."""
    if x <= 0 or y <= 0:
        return 0.0
    if np.hypot(x, y) < r:
        return 0.0
    q1y = y
    q1x = np.sqrt(max(r * r - y * y, 0.0))
    q2x = x
    q2y = np.sqrt(max(r * r - x * x, 0.0))
    return float(np.arctan2(q1y, q1x) - np.arctan2(q2y, q2x))


def _box_arc(p1: Point, p2: Point, r: float, center: Point) -> float:
    """Total arc covered by a slice's bounding box, as four quarter arcs."""
    n_p1 = Point(-(center.x - p1.x), center.y - p1.y)
    n_p2 = Point(p2.x - center.x, -(p2.y - center.y))
    quarters = [(abs(n_p2.x), abs(n_p2.y)),
                (abs(n_p1.y), abs(n_p2.x)),
                (abs(n_p1.x), abs(n_p1.y)),
                (abs(n_p2.y), abs(n_p1.x))]
    return sum(_minibox_arc(qx, qy, r) for qx, qy in quarters)


def _side_coincidences(outer: Tuple[Point, Point], box: Tuple[Point, Point]
                       ) -> int:
    return sum([
        bool(np.isclose(outer[0].x, box[0].x, atol=4)),
        bool(np.isclose(outer[1].x, box[1].x, atol=4)),
        bool(np.isclose(outer[0].y, box[0].y, atol=4)),
        bool(np.isclose(outer[1].y, box[1].y, atol=4)),
    ])


def get_pie_areas(detector_bboxes: np.ndarray
                  ) -> Tuple[List[Optional[float]], Optional[Point],
                             Optional[float]]:
    """Returns (angles aligned to input boxes with None for previews,
    center, radius)."""
    point_boxes = [(Point(b[0], b[1]), Point(b[2], b[3]))
                   for b in detector_bboxes]
    big = [b for b in point_boxes
           if (b[1].x - b[0].x) * (b[1].y - b[0].y) >= PREVIEW_AREA_THRESHOLD]
    if not big:
        return [None] * len(detector_bboxes), None, None
    p1 = Point(min(b[0].x for b in big), min(b[0].y for b in big))
    p2 = Point(max(b[1].x for b in big), max(b[1].y for b in big))
    r = max(p2.x - p1.x, p2.y - p1.y) / 2
    center = Point((p1.x + p2.x) / 2, (p1.y + p2.y) / 2)

    biggest = max(big, key=lambda b: _side_coincidences((p1, p2), b))
    angles = [_box_arc(b[0], b[1], r, center) for b in big]
    for i, b in enumerate(big):
        if b is biggest:
            angles[i] = 2 * np.pi - sum(angles[:i] + angles[i + 1:])
            break

    out: List[Optional[float]] = []
    j = 0
    for b in point_boxes:
        if (b[1].x - b[0].x) * (b[1].y - b[0].y) >= PREVIEW_AREA_THRESHOLD:
            out.append(angles[j])
            j += 1
        else:
            out.append(None)
    return out, center, r
