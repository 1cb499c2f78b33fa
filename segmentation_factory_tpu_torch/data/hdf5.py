"""HDF5 datasets without h5py: a reader on ``struct``, ``zlib`` and numpy.

The port's counterpart of the h5py reads in the JAX package's
``SynapseCT.volumes`` (``data/datasets.py``): Synapse's val volumes are
``.npy.h5`` files, and the machine with the card has no h5py. It reads the
subset of the format that h5py writes with its default settings
(``libver="earliest"``):

- superblock version 0, at the start of the file;
- version-1 object headers, with continuation messages;
- symbol-table groups: the version-1 B-tree of group nodes, ``SNOD`` symbol
  nodes and the local heap, so a path may go through groups (``"a/b/x"``);
- the dataspace message (version 1);
- the datatype message for fixed-point numbers of 1, 2, 4 and 8 bytes and
  IEEE floating-point numbers of 2, 4 and 8 bytes, little- or big-endian,
  signed or unsigned;
- the layout message version 3: contiguous, and chunked through the
  version-1 B-tree of chunks (edge chunks stored whole and cut here);
- the filter pipeline (version 1): deflate (id 1) and shuffle (id 2).

Anything else raises ``NotImplementedError`` naming the feature: compact
layouts, files written with a later ``libver`` (superblock 1-3, ``OHDR``
object headers, link messages, later message versions), a user block,
shared messages, other filters (lzf, szip, Fletcher-32, ...), compound,
string, enum or array types, external storage.

    read_dataset("case0001.npy.h5", "image")  # -> np.ndarray, stored dtype
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNPORTED = "is not ported (the port reads h5py's default files)"
# object header message types
_DATASPACE, _DATATYPE, _EXTERNAL, _LAYOUT, _PIPELINE, _CONTINUATION, _SYMBOLS = (
    0x1, 0x3, 0x7, 0x8, 0xB, 0x10, 0x11)
_LINK, _LINK_INFO = 0x6, 0x2
_DEFLATE, _SHUFFLE = 1, 2  # the filters read


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5: {what} {_UNPORTED}")


class _File:
    """The bytes of one file and the sizes its superblock declares."""

    def __init__(self, data: bytes):
        self.data = data
        if data[:8] != SIGNATURE:
            raise ValueError("not an HDF5 file (or one with a user block): no signature at 0")
        if data[8] != 0:
            raise _unported(f"superblock version {data[8]} (a later libver)")
        self.so, self.sl = data[13], data[14]
        self.base = self.offset(24)
        # after the base, free-space, end-of-file and driver addresses: the
        # root group's symbol table entry (name offset, header address)
        self.root = self.offset(24 + 5 * self.so) + self.base

    def unpack(self, fmt: str, pos: int):
        return struct.unpack_from("<" + fmt, self.data, pos)

    def _uint(self, pos: int, size: int) -> int:
        return int.from_bytes(self.data[pos:pos + size], "little")

    def offset(self, pos: int) -> int:
        return self._uint(pos, self.so)

    def length(self, pos: int) -> int:
        return self._uint(pos, self.sl)

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.so)) - 1

    def messages(self, addr: int) -> Dict[int, int]:
        """Type -> data position of the messages of the version-1 object
        header at ``addr``, continuation blocks followed."""
        if self.data[addr:addr + 4] == b"OHDR":
            raise _unported("a version-2 object header (libver='latest')")
        version, _, count = self.unpack("BBH", addr)
        if version != 1:
            raise _unported(f"object header version {version}")
        (size,) = self.unpack("I", addr + 8)
        blocks, out, seen = [(addr + 16, size)], {}, 0
        while blocks and seen < count:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and seen < count:
                mtype, msize, flags = self.unpack("HHB", pos)
                if flags & 0x2:
                    raise _unported(f"a shared message (type {mtype:#x})")
                out.setdefault(mtype, pos + 8)
                seen += 1
                if mtype == _CONTINUATION:
                    blocks.append((self.offset(pos + 8) + self.base,
                                   self.length(pos + 8 + self.so)))
                pos += 8 + msize
        return out

    # ------------------------------------------------------------ groups

    def children(self, addr: int) -> Dict[str, int]:
        """Name -> object header address of the members of the group whose
        header is at ``addr``."""
        msgs = self.messages(addr)
        if _LINK in msgs or _LINK_INFO in msgs:
            raise _unported("a group of link messages (libver='latest')")
        if _SYMBOLS not in msgs:
            raise KeyError("HDF5: the object is not a group")
        pos = msgs[_SYMBOLS]
        tree, heap = self.offset(pos) + self.base, self.offset(pos + self.so) + self.base
        if self.data[heap:heap + 4] != b"HEAP":
            raise ValueError("HDF5: bad local heap signature")
        names = self.offset(heap + 8 + 2 * self.sl) + self.base
        out: Dict[str, int] = {}
        for _, snod in self._btree(tree, 0, self.sl):
            if self.data[snod:snod + 4] != b"SNOD":
                raise ValueError("HDF5: bad symbol node signature")
            (n,) = self.unpack("H", snod + 6)
            entry = 2 * self.so + 24
            for i in range(n):
                e = snod + 8 + i * entry
                start = names + self.offset(e)
                name = self.data[start:self.data.index(b"\0", start)].decode()
                out[name] = self.offset(e + self.so) + self.base
        return out

    def _btree(self, addr: int, kind: int, key_size: int):
        """(key position, child address) of every entry of the level-0
        nodes of the version-1 B-tree at ``addr`` of node type ``kind``."""
        if self.data[addr:addr + 4] != b"TREE":
            raise ValueError("HDF5: bad B-tree signature")
        ntype, level, used = self.unpack("BBH", addr + 4)
        if ntype != kind:
            raise ValueError(f"HDF5: B-tree node type {ntype}, expected {kind}")
        pos = addr + 8 + 2 * self.so
        for i in range(used):
            key = pos + i * (key_size + self.so)
            child = self.offset(key + key_size) + self.base
            if level:
                yield from self._btree(child, kind, key_size)
            else:
                yield key, child

    # ------------------------------------------------------------ datasets

    def dataset(self, addr: int) -> np.ndarray:
        msgs = self.messages(addr)
        if _EXTERNAL in msgs:
            raise _unported("external storage")
        for t in (_DATASPACE, _DATATYPE, _LAYOUT):
            if t not in msgs:
                raise KeyError("HDF5: the object is not a dataset")
        shape = self._dataspace(msgs[_DATASPACE])
        dtype = self._datatype(msgs[_DATATYPE])
        filters = self._pipeline(msgs[_PIPELINE]) if _PIPELINE in msgs else []
        return self._layout(msgs[_LAYOUT], shape, dtype, filters)

    def _dataspace(self, pos: int) -> Tuple[int, ...]:
        version, rank = self.unpack("BB", pos)
        if version != 1:
            raise _unported(f"dataspace version {version}")
        return tuple(self.length(pos + 8 + i * self.sl) for i in range(rank))

    def _datatype(self, pos: int) -> np.dtype:
        cls, bits = self.data[pos] & 0x0F, self.data[pos + 1]
        (size,) = self.unpack("I", pos + 4)
        order = ">" if bits & 0x1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return np.dtype(f"{order}f{size}")
        names = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                 5: "opaque", 6: "compound", 7: "reference", 8: "enum",
                 9: "variable-length", 10: "array"}
        raise _unported(f"the {names.get(cls, f'class-{cls}')} datatype of {size} bytes")

    def _pipeline(self, pos: int) -> List[Tuple[int, Tuple[int, ...]]]:
        version, n = self.data[pos], self.data[pos + 1]
        if version != 1:
            raise _unported(f"filter pipeline version {version}")
        pos += 8
        out = []
        for _ in range(n):
            fid, name_len, _, nvals = self.unpack("HHHH", pos)
            pos += 8 + (name_len + 7) // 8 * 8  # the name, padded to 8 bytes
            vals = self.unpack(f"{nvals}I", pos)
            pos += 4 * (nvals + nvals % 2)  # the values, padded to 8 bytes
            if fid not in (_DEFLATE, _SHUFFLE):
                raise _unported(f"filter {fid}")
            out.append((fid, vals))
        return out

    def _layout(self, pos: int, shape, dtype: np.dtype, filters) -> np.ndarray:
        version, kind = self.data[pos], self.data[pos + 1]
        if version != 3:
            raise _unported(f"data layout version {version}")
        count = int(np.prod(shape, dtype=np.int64))
        if kind == 1:  # contiguous
            addr = self.offset(pos + 2)
            if self.undefined(addr):  # never written: the fill value 0
                return np.zeros(shape, dtype)
            return np.frombuffer(self.data, dtype, count, addr + self.base).reshape(shape).copy()
        if kind != 2:
            raise _unported("a compact data layout" if kind == 0 else f"data layout class {kind}")
        rank = self.data[pos + 2] - 1
        tree = self.offset(pos + 3)
        chunk = self.unpack(f"{rank}I", pos + 3 + self.so)
        out = np.zeros(shape, dtype)
        if self.undefined(tree):
            return out
        key_size = 8 + 8 * (rank + 1)
        chunk_bytes = int(np.prod(chunk, dtype=np.int64)) * dtype.itemsize
        for key, addr in self._btree(tree + self.base, 1, key_size):
            nbytes, mask = self.unpack("II", key)
            origin = self.unpack(f"{rank}Q", key + 8)
            raw = self.data[addr:addr + nbytes]
            for i in reversed(range(len(filters))):
                if not mask >> i & 1:
                    raw = _unfilter(raw, *filters[i])
            if len(raw) != chunk_bytes:
                raise ValueError(f"HDF5: a chunk of {len(raw)} bytes, expected {chunk_bytes}")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(origin, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out


def _unfilter(raw: bytes, fid: int, vals: Tuple[int, ...]) -> bytes:
    """Undo filter ``fid`` (deflate or shuffle) on one chunk's bytes."""
    if fid == _DEFLATE:
        return zlib.decompress(raw)
    size = vals[0] if vals else 1  # shuffle: bytes of each element, plane by plane
    n = len(raw) // size
    if size <= 1 or n <= 1:
        return raw
    planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return planes.T.tobytes() + raw[n * size:]


def read_dataset(path: str, name: str) -> np.ndarray:
    """The dataset at ``name`` (a path from the root group, ``/`` between
    groups) of the HDF5 file at ``path``, in its stored dtype and shape, as
    ``np.asarray(h5py.File(path)[name])`` gives it."""
    with open(path, "rb") as f:
        hf = _File(f.read())
    addr = hf.root
    for part in [p for p in name.split("/") if p]:
        members = hf.children(addr)
        if part not in members:
            raise KeyError(f"{path}: no object {name!r}")
        addr = members[part]
    return hf.dataset(addr)
