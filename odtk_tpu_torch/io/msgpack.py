"""The msgpack format of ``flax.serialization`` that the JAX package's
``.ckpt`` files and optimizer blobs use, without flax or msgpack.

``msgpack_serialize`` writes the bytes ``flax.serialization.
msgpack_serialize`` writes for the same tree: maps with their keys in
sorted order (flax copies the tree with ``jax.tree_util.tree_map``, which
sorts them), the smallest encoding of each value as msgpack-python picks
it, arrays as ext 1 and numpy scalars as ext 3 (the payload is the
msgpack array ``(shape, dtype name, C-order bytes)``), and an array
above ``MAX_CHUNK_SIZE`` bytes that is a map value (or the whole tree)
as a ``__msgpack_chunked_array__`` map of flat chunks.

Values: dicts with str keys, lists (a tuple is refused, as flax's
strict encoder refuses it), str, bytes (bin), None, bool, ints of every width, float (float64), numpy arrays
and scalars, and torch tensors (written as arrays). Array dtypes:
float32, float16, bfloat16, int32, int64, uint8, bool; numpy has no
bfloat16, so a bfloat16 array decodes as a torch tensor.

``msgpack_restore`` decodes arrays with ``np.frombuffer`` over the
given buffer, without a copy: they are writable only if the buffer is
(a ``bytearray``), and keep it alive.
"""

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30      # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = '__msgpack_chunked_array__'
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_TORCH_DTYPES = {torch.float32: 'float32', torch.float16: 'float16',
                 torch.bfloat16: 'bfloat16', torch.int32: 'int32',
                 torch.int64: 'int64', torch.uint8: 'uint8',
                 torch.bool: 'bool'}


# ----------------------------------------------------------------- encode
def _int(n):
    if 0 <= n < 0x80:
        return struct.pack('B', n)
    if -0x20 <= n < 0:
        return struct.pack('b', n)
    if 0x80 <= n <= 0xFF:
        return struct.pack('>BB', 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack('>Bb', 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack('>BH', 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack('>Bh', 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack('>BI', 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack('>Bi', 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack('>BQ', 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack('>Bq', 0xD3, n)
    raise OverflowError(f'integer {n} does not fit 64 bits')


def _sized(n, small, codes):
    """The header of a str / bin / array / map of length ``n``: a fix
    form below ``small`` (a prefix byte, or None), then 8-, 16- and 32-bit
    lengths (a code each, None where msgpack has no such form)."""
    if small is not None and n < small[1]:
        return struct.pack('B', small[0] | n)
    for code, fmt, limit in zip(codes, ('>BB', '>BH', '>BI'),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return struct.pack(fmt, code, n)
    raise ValueError(f'length {n} too large for msgpack')


def _str_header(n):
    return _sized(n, (0xA0, 32), (0xD9, 0xDA, 0xDB))


def _bin_header(n):
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _array_header(n):
    return _sized(n, (0x90, 16), (None, 0xDC, 0xDD))


def _map_header(n):
    return _sized(n, (0x80, 16), (None, 0xDE, 0xDF))


def _ext_header(code, n):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack('>Bb', fixed[n], code)
    return _sized(n, None, (0xC7, 0xC8, 0xC9)) + struct.pack('b', code)


def _array_parts(x):
    """(shape, dtype name, flat uint8 view of the C-order bytes) of a
    numpy array or torch tensor, copying only what is not contiguous."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_DTYPES:
            raise TypeError(f'cannot serialize a {t.dtype} tensor')
        name = _TORCH_DTYPES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return tuple(t.shape), name, t.numpy().reshape(-1).view(np.uint8)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError('Object and structured dtypes not supported for '
                         'serialization of ndarrays.')
    flat = x if x.flags.c_contiguous else np.array(x, order='C')
    return x.shape, x.dtype.name, flat.reshape(-1).view(np.uint8)


def _nbytes(x):
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.nbytes


def _pack_array(x, out, code=_EXT_NDARRAY):
    shape, name, data = _array_parts(x)
    head = [struct.pack('B', 0x93), _array_header(len(shape))]
    head += [_int(int(d)) for d in shape]
    name = name.encode()
    head += [_str_header(len(name)), name, _bin_header(data.nbytes)]
    head = b''.join(head)
    out.append(_ext_header(code, len(head) + data.nbytes))
    out.append(head)
    out.append(memoryview(data))


def _chunk(x):
    """flax's ``_chunk``: the array as a map of flat chunks of at most
    ``MAX_CHUNK_SIZE`` bytes (keys in this order, not sorted)."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return _Ordered({
        _CHUNKED: True,
        'shape': _Ordered({str(i): int(d) for i, d in enumerate(x.shape)}),
        'chunks': _Ordered({str(j): flat[i:i + size] for j, i in
                            enumerate(range(0, n, size))})})


class _Ordered(dict):
    """A map written in its own key order (flax's chunk maps are built
    after its tree copy sorted the others)."""


def _is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pack(obj, out, chunk=True):
    t = type(obj)
    if obj is None:
        out.append(b'\xc0')
    elif t is bool:
        out.append(b'\xc3' if obj else b'\xc2')
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(struct.pack('>Bd', 0xCB, obj))
    elif t is str:
        data = obj.encode()
        out += [_str_header(len(data)), data]
    elif t in (bytes, bytearray, memoryview):
        data = memoryview(obj).cast('B')
        out += [_bin_header(data.nbytes), data]
    elif t in (dict, _Ordered):
        keys = list(obj) if t is _Ordered else sorted(obj)
        out.append(_map_header(len(keys)))
        for k in keys:
            if type(k) is not str:
                raise TypeError(f'map key {k!r} is not a str')
            _pack(k, out)
            _pack(obj[k], out, chunk)
    elif t is list:
        # flax chunks the arrays it reaches through maps alone
        out.append(_array_header(len(obj)))
        for v in obj:
            _pack(v, out, False)
    elif _is_array(obj):
        if chunk and _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _pack_array(obj, out)
    elif isinstance(obj, np.generic):
        _pack_array(np.asarray(obj), out, _EXT_NPSCALAR)
    else:
        raise TypeError(f'cannot serialize {t.__name__}')


def serialize_parts(tree):
    """The encoding of ``tree`` as a list of buffers (arrays' memory is
    referenced, not copied): write them out in order."""
    out = []
    _pack(tree, out)
    return out


def msgpack_serialize(tree):
    """``flax.serialization.msgpack_serialize``: the bytes of ``tree``."""
    return b''.join(serialize_parts(tree))


# ----------------------------------------------------------------- decode
class _Reader:
    def __init__(self, buf, bin_views):
        self.buf = memoryview(buf).cast('B')
        self.pos = 0
        self.bin_views = bin_views

    def take(self, n):
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError('truncated msgpack data')
        return self.buf[start:self.pos]

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack('B')
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), 'utf-8')
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: '>B', 0xCD: '>H', 0xCE: '>I', 0xCF: '>Q', 0xD0: '>b',
                0xD1: '>h', 0xD2: '>i', 0xD3: '>q', 0xCA: '>f', 0xCB: '>d'}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: '>B', 0xC5: '>H', 0xC6: '>I', 0xD9: '>B',
                   0xDA: '>H', 0xDB: '>I', 0xDC: '>H', 0xDD: '>I',
                   0xDE: '>H', 0xDF: '>I', 0xC7: '>B', 0xC8: '>H',
                   0xC9: '>I'}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f'unknown msgpack type byte 0x{b:02x}')
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            data = self.take(n)
            return data if self.bin_views else bytes(data)
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return str(self.take(n), 'utf-8')
        return self.array(n) if b <= 0xDD else self.map(n)

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return _unchunk(out) if _CHUNKED in out else out

    def ext(self, n):
        code = self.unpack('b')
        payload = _Reader(self.take(n), bin_views=True)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f'unknown msgpack ext type {code}')
        shape, name, data = payload.value()
        arr = _frombuffer(data, name, shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def _frombuffer(data, name, shape):
    shape = tuple(shape)
    if name == 'bfloat16':
        arr = np.frombuffer(data, np.int16).reshape(shape)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def _unchunk(d):
    shape = tuple(d['shape'][str(i)] for i in range(len(d['shape'])))
    chunks = [d['chunks'][str(i)] for i in range(len(d['chunks']))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data, bin_views=False):
    """``flax.serialization.msgpack_restore``: the tree encoded in
    ``data`` (bytes, bytearray, memoryview or mmap). Arrays are views of
    ``data``; bin values are bytes, or with ``bin_views`` memoryviews of
    ``data`` (a nested blob then costs no copy)."""
    reader = _Reader(data, bin_views)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError('trailing bytes after the msgpack value')
    return tree
