"""Hand-written CUDA kernels (csrc/*.cu), each in a module with its plain
PyTorch version: ``nms`` and ``nms_rotated`` (greedy NMS), ``stem`` (BN +
ReLU + max pool, forward and backward), ``loss`` (the detection loss),
``focal`` (the focal sum and its gradient) and ``match_rotated`` (the
rotated anchor matcher). A wrapper takes its plain version for a CPU
tensor and launches its kernel for a CUDA tensor, counting launches in
``<wrapper>.launches``. NMS, rotated NMS and the primal stem are
``torch.library`` operators (``odtk::nms``, ``odtk::nms_rotated``,
``odtk::bn_relu_pool``), so exported engines keep them."""
