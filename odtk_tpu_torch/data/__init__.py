"""Data pipeline: the COCO dataset, host-side transforms, the prefetching
loader and a pycocotools-free COCO evaluator.

Copies of ``odtk_tpu/data/`` (axis-aligned and rotated boxes, u8 and
f32 feeds): the port imports nothing of ``odtk_tpu``;
``tests/test_torch_data.py`` and ``tests/test_torch_rotated.py`` hold
each copy equal to its original.
"""

from .coco import CocoDataset, CocoIndex, RotatedCocoDataset
from .coco_eval import CocoEvaluator
from .loader import DataIterator, RotatedDataIterator

__all__ = ['CocoDataset', 'CocoIndex', 'DataIterator', 'CocoEvaluator',
           'RotatedCocoDataset', 'RotatedDataIterator']
