"""Checkpoints in the file format of `repro.checkpoint.ckpt`, so that a
file written by either package loads in the other.

A tree (nested dicts, lists and tuples of tensors or numpy arrays) is
flattened to path-keyed records: the keys of each level joined by "/"
(dict keys in sorted order, list items by index, as JAX's
`tree_flatten_with_path` names them), each record {"dtype": name,
"shape": [ints], "data": raw bytes}; the file is the msgpack encoding of
{"step": int, "arrays": {key: record}}, written to a ".tmp" file and
moved into place with `os.replace`. bfloat16 goes by its dtype name
"bfloat16" as its raw bytes.

A placed tree (`repro_torch.sharding.placement.ShardedTensor` leaves, a
training state on a mesh) is gathered, as the reference gathers its
sharded arrays to the host before it saves: each placed leaf is written
as the record of the global tensor, so that one file loads in both
packages and onto any mesh. The file is written leaf by leaf (each leaf
gathered to the CPU, encoded, written and let go), so that a save holds
one gathered leaf at a time, and read through a memory map, one leaf at
a time. `load_checkpoint` places a leaf where its like-leaf is placed.

The machine with the card has no `msgpack`, so this module carries its
own encoder and decoder of the subset the format uses: maps with str
keys, str, int, bin, lists, and nil / bool / float64 for completeness.
The encoder picks the same (smallest) representations as
``msgpack.packb(obj, use_bin_type=True)``, byte for byte.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.sharding import placement

# dtype names of the format (numpy's, "bfloat16" as ml_dtypes names it)
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


# ------------------------------------------------------------------ msgpack
def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        out.append(bytes([0xa0 | n]) if n < 32 else
                   b"\xd9" + struct.pack(">B", n) if n <= 0xff else
                   b"\xda" + struct.pack(">H", n) if n <= 0xffff else
                   b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(b"\xc4" + struct.pack(">B", n) if n <= 0xff else
                   b"\xc5" + struct.pack(">H", n) if n <= 0xffff else
                   b"\xc6" + struct.pack(">I", n))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else
                   b"\xdc" + struct.pack(">H", n) if n <= 0xffff else
                   b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, Mapping):
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__}")


def _map_header(n: int) -> bytes:
    """The msgpack head of a map of `n` entries (its items follow)."""
    return (bytes([0x80 | n]) if n < 16 else
            b"\xde" + struct.pack(">H", n) if n <= 0xffff else
            b"\xdf" + struct.pack(">I", n))


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, hi in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                              (0xce, ">I", 0xffffffff),
                              (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= hi:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                              (0xd2, ">i", -0x80000000),
                              (0xd3, ">q", -0x8000000000000000)):
            if v >= lo:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit in 64 bits")


def packb(obj) -> bytes:
    """`obj` in msgpack, as ``msgpack.packb(obj, use_bin_type=True)``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# big-endian fixed-width forms: code -> (struct format, byte count)
_FIXED = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4),
          0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
          0xd2: (">i", 4), 0xd3: (">q", 8), 0xca: (">f", 4),
          0xcb: (">d", 8)}
_LEN = {0xd9: 1, 0xda: 2, 0xdb: 4, 0xc4: 1, 0xc5: 2, 0xc6: 4, 0xdc: 2,
        0xdd: 4, 0xde: 2, 0xdf: 4}


def _unpack(buf: memoryview, i: int, views: bool = False):
    """(object, end) of the encoding at byte i; with `views` a bin is a
    memoryview of `buf` (no copy) instead of bytes."""
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if c in _FIXED:
        fmt, n = _FIXED[c]
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if c == 0xc0:
        return None, i
    if c in (0xc2, 0xc3):
        return c == 0xc3, i
    kind, n = None, 0
    if 0xa0 <= c <= 0xbf:
        kind, n = "str", c & 0x1f
    elif 0x90 <= c <= 0x9f:
        kind, n = "list", c & 0x0f
    elif 0x80 <= c <= 0x8f:
        kind, n = "map", c & 0x0f
    elif c in _LEN:
        w = _LEN[c]
        n = int.from_bytes(buf[i:i + w], "big")
        i += w
        kind = ("str" if c in (0xd9, 0xda, 0xdb) else
                "bin" if c in (0xc4, 0xc5, 0xc6) else
                "list" if c in (0xdc, 0xdd) else "map")
    else:
        raise ValueError(f"msgpack type 0x{c:02x} at byte {i - 1} is not "
                         f"in the checkpoint format")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("truncated msgpack data")
        if kind == "bin" and views:
            return buf[i:i + n], i + n
        raw = bytes(buf[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "list":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i, views)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i, views)
        out[k], i = _unpack(buf, i, views)
    return out, i


def unpackb(data) -> Any:
    """The object of one msgpack encoding (str for str, bytes for bin),
    as ``msgpack.unpackb(data, raw=False)`` gives it for the subset
    above; trailing bytes raise."""
    buf = memoryview(data).cast("B")
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the object")
    return obj


# -------------------------------------------------------------------- trees
def _items(tree):
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


@torch.no_grad()
def _record(leaf) -> dict:
    """The record of one leaf; a placed leaf gathered to the CPU. The
    data is a view of the CPU tensor's bytes (no further copy)."""
    if placement.is_sharded(leaf):
        leaf = placement.gather(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        data = memoryview(t.reshape(-1).view(torch.uint8).numpy())
        shape = list(t.shape)
    else:
        a = np.ascontiguousarray(leaf)
        name, data, shape = a.dtype.name, a.tobytes(), list(a.shape)
    if name not in _DTYPES:
        raise TypeError(f"dtype {name} is not in the checkpoint format")
    return {"dtype": name, "shape": shape, "data": data}


def _tensor(rec: Mapping) -> torch.Tensor:
    name = rec["dtype"]
    if name not in _DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} is not supported")
    raw = torch.from_numpy(np.frombuffer(rec["data"], np.uint8).copy())
    return raw.view(_DTYPES[name]).reshape(rec["shape"])


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write `tree` (tensors on any device, numpy arrays, or placed
    tensors, each gathered) and `step` to `path` atomically: a ".tmp"
    file, then `os.replace`. The leaves are written one at a time, in
    the bytes ``msgpack.packb({"step": step, "arrays": records})`` gives."""
    leaves = _flatten(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    head: list = [_map_header(2)]
    for obj in ("step", int(step), "arrays"):
        _pack(obj, head)
    head.append(_map_header(len(leaves)))
    with open(tmp, "wb") as f:
        f.write(b"".join(head))
        for key, leaf in leaves.items():
            chunks: list = []
            _pack(key, chunks)
            _pack(_record(leaf), chunks)
            for chunk in chunks:
                f.write(chunk)
            del chunks
    os.replace(tmp, path)


def _read(path: str) -> Tuple[Dict[str, Mapping], int]:
    """The file's records, each record's data a view of the file mapped
    into memory (read as a leaf is built, one at a time), and its step."""
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    buf = memoryview(mapped)
    payload, end = _unpack(buf, 0, views=True)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the object")
    return payload["arrays"], payload["step"]


def read_tree(path: str) -> Tuple[Dict, int]:
    """Every array of a checkpoint as CPU tensors in a nested dict, keys
    split at "/" (a key of digits becomes an int, so a JAX tree's tuple
    items and int-keyed dicts index as they did). Returns (tree, step)."""
    arrays, step = _read(path)
    tree: Dict = {}
    for key, rec in arrays.items():
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(rec)
    return tree, step


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of `like` (nested dicts / lists /
    tuples of tensors, arrays or placed tensors): each leaf becomes a
    tensor of the file's dtype on the like-leaf's device (the CPU for
    arrays), its shape checked against the leaf's (a placed leaf's global
    shape). A placed like-leaf gives a placed leaf: the file's array
    `shard`ed by the like-leaf's sharding on its mesh, each block taking
    its like-block's `requires_grad`, so that a file saved on one mesh
    (or unplaced) loads onto any other. Returns (tree, step)."""
    arrays, step = _read(path)

    def build(node, prefix):
        items = _items(node)
        if items is None:
            if prefix not in arrays:
                raise KeyError(f"checkpoint missing {prefix}")
            t = _tensor(arrays[prefix])
            if tuple(t.shape) != tuple(node.shape):
                raise ValueError(f"{prefix}: shape {tuple(t.shape)} in the "
                                 f"file, expected {tuple(node.shape)}")
            if placement.is_sharded(node):
                st = placement.shard(t, node.sharding)
                for b, want in zip(st.locals, node.locals):
                    b.requires_grad_(want.requires_grad)
                return st
            dev = node.device if isinstance(node, torch.Tensor) else "cpu"
            return t.to(dev)
        built = {k: build(v, f"{prefix}/{k}" if prefix else k)
                 for k, v in items}
        if isinstance(node, Mapping):
            return {k: built[str(k)] for k in node}
        return type(node)(built[str(i)] for i in range(len(node)))

    return build(like, ""), step
