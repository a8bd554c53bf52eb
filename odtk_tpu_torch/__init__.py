"""odtk_tpu_torch — the RetinaNet toolkit of ``odtk_tpu`` ported to PyTorch
and CUDA on NVIDIA Hopper (H100).

It mirrors ``odtk_tpu``'s module layout so that each module's JAX
counterpart sits at the same path. It imports ``torch`` and never JAX,
and nothing of ``odtk_tpu``: it keeps copies of the framework-free
pieces it needs (``data/``, ``utils.py``, the anchor table), held equal
to their originals by tests. Every Pallas kernel that the JAX package
runs on this package's path is a hand-written CUDA kernel under
``csrc/``, built by ``ops/kernels/_build.py`` on first use, with a plain
PyTorch version beside it for CPU tensors and tests.

Covered so far, axis-aligned and rotated, with every backbone of the
JAX registry (the ResNet/ResNeXt FPNs, MobileNetV2FPN, ResNet18C4 and
ResNet34C4) and models of several backbones: inference
(``odtk-tpu-torch infer``) and training (``odtk-tpu-torch train``, with
every flag of the JAX CLI), both data parallel at world > 1
(``parallel/``: one process a card over NCCL, gloo on the CPU), and
export (``odtk-tpu-torch export``: ``.engine`` packages, a ``.pt2``
program, and ``.cppengine`` AOTInductor packages that the C++ samples
of ``extras/cppapi`` run with the same kernels); ``extras/`` also holds
video inference, the anchor tables and the CLI harness. Checkpoints are ``.pth`` or
``.ckpt`` (flax msgpack, read and written without flax), and the
momentum carries over both ways through a ``.ckpt`` or the JAX
package's optax bytes; a ``.pth`` written here holds a ``torch.optim``
state_dict, as the original's schema has it.
"""

__version__ = '0.1.0'
