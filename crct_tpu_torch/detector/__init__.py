"""Detection stage: Mask R-CNN in PyTorch (the port of crct_tpu/detector).

ResNet-FPN backbone, RPN with fixed-k proposals, RoIAlign (its backward
through the hand-written kernel K3 when asked), fixed-shape NMS, box and
mask heads, the COCO-format data layer and the detector trainer; the
feature extractor (``extract.py``) with its text attachment (``ocr.py``,
``ocr_lite.py``) and pie geometry (``pie.py``), and the synthetic charts
the tests render. Modules carry Detectron2's names.
"""
