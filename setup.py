from setuptools import setup, find_packages

setup(
    name='odtk-tpu',
    version='0.3.0',
    description='TPU-native object detection toolkit (RetinaNet family): '
                'train, infer, export on JAX/XLA/Pallas',
    packages=find_packages(exclude=['tests']),
    python_requires='>=3.10',
    install_requires=['jax', 'flax', 'optax', 'numpy', 'Pillow'],
    # the PyTorch + CUDA port (odtk_tpu_torch): its kernels ship as
    # sources and are built with nvcc on first use
    extras_require={'torch': ['torch']},
    package_data={'odtk_tpu_torch': [
        'csrc/*.cu', 'csrc/*.cuh', 'extras/test.sh',
        'extras/cppapi/*.cpp', 'extras/cppapi/*.h',
        'extras/cppapi/CMakeLists.txt', 'extras/cppapi/README.md']},
    entry_points={'console_scripts': [
        'odtk-tpu = odtk_tpu.main:main',
        'odtk-tpu-torch = odtk_tpu_torch.main:main']},
)
