"""The ``decode_route`` fixture: both packages' loaders on one JPEG decoder.

A test that holds the port's loader equal to the JAX package's must pin
the decode route of both. Each package loads its own native library, and
the JAX package builds its own into the shared ``native/build/`` without a
lock, so under several pytest workers one build can fail while the other
succeeds, and the two loaders then decode with PIL and libjpeg, which
differ by a few grey levels. The fixture puts both on PIL (native library
off in both), or both on the port's native library.

Import it into a test module (``from torch_decode_route import
decode_route``) and name it as an argument.
"""

import pytest

import odtk_tpu.data.native as jax_native
from odtk_tpu_torch.data import native


@pytest.fixture(params=['pil', 'native'])
def decode_route(request, monkeypatch):
    """Both loaders on PIL, or both on the port's native library."""
    if request.param == 'pil':
        monkeypatch.setattr(native, '_load', lambda: None)
        monkeypatch.setattr(jax_native, '_load', lambda: None)
    else:
        lib = native._load()
        assert lib is not None, 'the native decoder did not build'
        monkeypatch.setattr(lib, '_has_u8', True, raising=False)
        monkeypatch.setattr(jax_native, '_load', lambda: lib)
    return request.param
