"""FigureQA-specific data handling: detector-class -> color-name mapping.

The port's copy of ``crct_tpu/data/figureqa.py`` (numpy only).
The FigureQA detector predicts per-color element classes; at test time the
question templates reference *unseen* color names, so tick/legend texts and
the question string are rewritten using the color of the nearest detected
element (reference Color_Mapping, CRCT/fig_dataloader.py:733-954). The
class-id -> color-name table is the detector's training taxonomy.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional

import numpy as np

CID_TO_COLOR: Dict[int, str] = {
    8: 'Royal Blue', 9: 'Pale Green', 10: 'Dark Red', 11: 'Light Green',
    12: 'Dark Salmon', 13: 'Coral', 14: 'Medium Purple', 15: 'Purple',
    16: 'Dark Turquoise', 17: 'Orange Red', 18: 'Saddle Brown',
    19: 'Navy Blue', 20: 'Violet', 21: 'Salmon', 22: 'Teal',
    23: 'Dark Khaki', 24: 'Lawn Green', 25: 'Yellow Green',
    26: 'Medium Orchid', 27: 'Blue', 28: 'Forest Green', 29: 'Turquoise',
    30: 'Cornflower', 31: 'Medium Aqua', 32: 'Medium Seafoam', 33: 'Gold',
    34: 'Deep Pink', 35: 'Rosy Brown', 36: 'Sky Blue', 37: 'Olive Drab',
    38: 'Medium Mint', 39: 'Web Green', 40: 'Green', 41: 'Chartreuse',
    42: 'Medium Periwinkle', 43: 'Sandy Brown', 44: 'Lime Green',
    45: 'Dark Cyan', 46: 'Indian Red', 47: 'Chocolate', 48: 'Tan',
    49: 'Light Coral', 50: 'Dark Seafoam', 51: 'Rebecca Purple',
    52: 'Yellow', 53: 'Web Purple', 54: 'Indigo', 55: 'Medium Turquoise',
    56: 'Dodger Blue', 57: 'Dark Periwinkle', 58: 'Cadet Blue',
    59: 'Dark Violet', 60: 'Dark Slate', 61: 'Black', 62: 'Dark Olive',
    63: 'Light Sky Blue', 64: 'Burlywood', 65: 'Deep Sky Blue',
    66: 'Medium Blue', 67: 'Steel Blue', 68: 'Gray', 69: 'Light Seafoam',
    70: 'Violet Red', 71: 'Dark Orange', 72: 'Khaki', 73: 'Peru',
    74: 'Crimson', 75: 'Orange', 76: 'Periwinkle', 77: 'Light Salmon',
    78: 'Tomato', 79: 'Blue Violet', 80: 'Light Gold', 81: 'Olive',
    82: 'Dark Magenta', 83: 'Firebrick', 84: 'Bubblegum', 85: 'Dark Green',
    86: 'Dim Gray', 87: 'Midnight Blue', 88: 'Green Yellow', 89: 'Aqua',
    90: 'Red', 91: 'Mint', 92: 'Slate', 93: 'Web Gray', 94: 'Seafoam',
    95: 'Dark Gold', 96: 'Dark Gray', 97: 'Web Maroon', 98: 'Sienna',
    99: 'Maroon', 100: 'Light Slate', 101: 'Orchid', 102: 'Brown',
    103: 'Hot Pink', 104: 'Cyan', 105: 'Dark Orchid', 106: 'Magenta',
    107: 'Dark Blue',
}


class ColorMapping:
    """Rewrites FigureQA test-split texts using nearest-detection colors."""

    def get_previews(self, fig_feat: Dict[str, Any]) -> np.ndarray:
        """Boolean mask of legend-preview-sized boxes in image coordinates
        (reference fig_dataloader.py:836-859)."""
        vis_bbox = deepcopy(np.asarray(fig_feat['vis_bbox'], np.float64))
        tf = fig_feat['text_feat']
        if 'pie' in tf:
            vis_bbox = vis_bbox * tf['pie']['radius']
            vis_bbox[:, 1] *= -1
            vis_bbox[:, 3] *= -1
        else:
            vis_bbox[:, [0, 2]] *= tf['x_axis']['w']
            vis_bbox[:, [0, 2]] += tf['y_axis']['x']
            vis_bbox[:, [1, 3]] *= tf['y_axis']['h']
            vis_bbox[:, [1, 3]] = tf['x_axis']['y'] - vis_bbox[:, [1, 3]]
        area = (vis_bbox[:, 2] - vis_bbox[:, 0]) * \
            (vis_bbox[:, 3] - vis_bbox[:, 1])
        return (area > 350) & (area < 455)

    @staticmethod
    def closest_node(node: np.ndarray, nodes: np.ndarray) -> Optional[int]:
        nodes = np.asarray(nodes)
        if len(nodes) == 0:
            return None
        deltas = nodes - node
        return int(np.argmin(np.einsum('ij,ij->i', deltas, deltas)))

    def get_nearest_mapping(self, fig_feat: Dict[str, Any]
                            ) -> Optional[Dict[str, str]]:
        """label/tick text -> detected color name (fig_dataloader.py:903-954)."""
        mapping: Dict[str, str] = {}
        tf = fig_feat['text_feat']
        bbox = np.asarray(fig_feat['vis_bbox'], np.float64)
        cls = np.asarray(fig_feat['class'])
        if 'legend' in tf:
            previews = self.get_previews(fig_feat)
            x = (bbox[:, 0] + bbox[:, 2]) / 2
            y = (bbox[:, 1] + bbox[:, 3]) / 2
            nodes = np.stack([x, y], axis=1)[previews]
            for i, lb in enumerate(tf['legend']['bbox']):
                point = np.array([lb[0], (lb[1] + lb[3]) / 2])
                closest = self.closest_node(point, nodes)
                if closest is None:
                    return None
                if abs(nodes[closest][1] - point[1]) <= 5e-2:
                    cid = int(cls[previews][closest])
                    if cid in CID_TO_COLOR:
                        mapping[tf['legend']['label'][i]] = CID_TO_COLOR[cid]
            return mapping
        # no legend: map the categorical axis's tick labels
        ax = 'x_axis'
        for candidate in ('x_axis', 'y_axis'):
            t, _ = tf[candidate]['ticks'][1]
            try:
                float(t)
                continue
            except (TypeError, ValueError):
                ax = candidate
                break
        if ax == 'x_axis':
            nodes = np.stack([(bbox[1:, 0] + bbox[1:, 2]) / 2,
                              bbox[1:, 3] * 0], axis=1)
            same_ax = 0
        else:
            nodes = np.stack([bbox[1:, 0] * 0,
                              (bbox[1:, 1] + bbox[1:, 3]) / 2], axis=1)
            same_ax = 1
        for name, pos in tf[ax]['ticks']:
            point = (np.array([pos, 0]) if ax == 'x_axis'
                     else np.array([0, pos]))
            closest = self.closest_node(point, nodes)
            if closest is None:
                return None
            if abs(nodes[closest][same_ax] - point[same_ax]) <= 5e-2:
                cid = int(cls[1:][closest])
                if cid in CID_TO_COLOR:
                    mapping[name] = CID_TO_COLOR[cid]
        return mapping

    def feature_replace(self, params: Dict[str, Any], qa_pair: Dict[str, Any],
                        fig_feat: Dict[str, Any]) -> None:
        """Rewrite tick/legend texts + the question template in place
        (fig_dataloader.py:869-901)."""
        mapping_dict = self.get_nearest_mapping(fig_feat)
        if mapping_dict is None:
            return
        mapping = lambda key: mapping_dict.get(key, key)
        tf = fig_feat['text_feat']
        for ax in ('x_axis', 'y_axis'):
            if ax in tf:
                tf[ax]['ticks'] = [(mapping(t), pos)
                                   for t, pos in tf[ax]['ticks']]
        if 'legend' in tf:
            tf['legend']['label'] = np.array(
                [mapping(lb) for lb in tf['legend']['label']])
        c1 = mapping(qa_pair['color1_name'])
        c2 = "$_c2_$"
        if qa_pair.get('color2_name', '--None--') != '--None--':
            c2 = mapping(qa_pair['color2_name'])
        template = params['question_templates'][str(qa_pair['question_id'] + 1)]
        qa_pair['question_string'] = template.replace("$_c1_$", c1) \
                                             .replace("$_c2_$", c2)
