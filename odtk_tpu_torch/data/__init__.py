"""Data pipeline: the COCO dataset, host-side transforms, the prefetching
loader and a pycocotools-free COCO evaluator.

Copies of ``odtk_tpu/data/`` (axis-aligned boxes, u8 and f32 feeds):
the port imports nothing of ``odtk_tpu``; ``tests/test_torch_data.py``
holds each copy equal to its original.
"""

from .coco import CocoDataset, CocoIndex
from .coco_eval import CocoEvaluator
from .loader import DataIterator

__all__ = ['CocoDataset', 'CocoIndex', 'DataIterator', 'CocoEvaluator']
