"""Reading the JAX package's msgpack files without flax: the
``model_ckpt_steps_*.ckpt`` checkpoints of ``neuralsvb_tpu/training/checkpoint.py``
(``{epoch, global_step, checkpoint_callback_best, state}``) and the
``params.msgpack`` files of ``flax.serialization.to_bytes``.

flax writes a msgpack map of maps whose leaves are Python scalars, strings,
None and arrays. An array is msgpack ext type 1 holding a second msgpack
object ``(shape, dtype name, C-order bytes)``; ext type 3 is a numpy scalar
in the same form; ext type 2 a complex ``(real, imag)``. An array above 2^30
bytes is written as ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat chunk, ...}}`` and is joined back here. The dtype name
``bfloat16`` (which numpy lacks) decodes to a ``torch.bfloat16`` tensor
through a ``uint16`` view; every other array decodes to numpy.

The decoder below reads the subset of msgpack that flax writes, with no
``msgpack`` package; a malformed file raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


def _array(shape, dtype_name: bytes, buf: bytes):
    shape = tuple(int(d) for d in shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(dtype_name.decode("ascii"))
    except (TypeError, UnicodeDecodeError) as e:
        raise ValueError(f"unknown array dtype {dtype_name!r}") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        tpl = _unpack(data, True)
        if not (isinstance(tpl, list) and len(tpl) == 3):
            raise ValueError("malformed ndarray ext payload")
        arr = _array(*tpl)
        return arr if code == EXT_NDARRAY else arr[()]
    if code == EXT_COMPLEX:
        re_im = _unpack(data, False)
        return complex(re_im[0], re_im[1])
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    """Join flax's chunked arrays back, in place; returns the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if chunks and torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


class _Reader:
    """msgpack's formats, decoded from ``data``; ``raw`` keeps str as bytes."""

    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        if self.raw:
            return b
        try:
            return b.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError("malformed msgpack string") from e

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, (list, dict)):
                raise ValueError("unhashable msgpack map key")
            out[k] = self.obj()
        return out

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", lambda n: bytes(self.take(n))),
                 0xC5: (">H", lambda n: bytes(self.take(n))),
                 0xC6: (">I", lambda n: bytes(self.take(n))),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
                 0xD9: (">B", self.string), 0xDA: (">H", self.string),
                 0xDB: (">I", self.string),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _unpack(data: bytes, raw: bool):
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return out


def restore(data: bytes):
    """flax msgpack bytes -> nested dicts (lists) of numpy arrays (bf16
    leaves as ``torch.bfloat16`` tensors), scalars, strings and None."""
    return _unchunk(_unpack(bytes(data), False))


def load(path: str):
    with open(path, "rb") as f:
        return restore(f.read())
