"""Hand-written CUDA kernels (csrc/*.cu), each in a module with its plain
PyTorch version: ``nms`` and ``nms_rotated`` (greedy NMS), ``stem`` (BN +
ReLU + max pool, forward and backward), ``loss`` (the detection loss),
``focal`` (the focal sum and its gradient), ``match_rotated`` (the
rotated anchor matcher) and ``conv_w8a8`` (the w8a8 int8 convolution).
A wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor, counting launches in ``<wrapper>.launches``.
NMS, rotated NMS, the primal stem and the w8a8 convolution are
``torch.library`` operators (``odtk::nms``, ``odtk::nms_rotated``,
``odtk::bn_relu_pool``, ``odtk::conv_w8a8``), so exported engines keep
them."""
