"""Orbax checkpoint directories, read and written without orbax.

The JAX package saves parameter trees and solver states with orbax
(``ctpn_tpu/utils/weights.py::export_params``, ``training/solver.py``). This
module is the port's own copy of that on-disk format, so that a JAX user's
artifact loads on a machine with neither JAX, orbax nor tensorstore.

A checkpoint directory holds ``_CHECKPOINT_METADATA`` and ``_METADATA``
(JSON). ``_METADATA["tree_metadata"]`` lists every leaf with its key path
(``key_metadata``); a leaf ``('a', 'b', 'c')`` is the zarr v2 array named
``a.b.c`` in the directory's key-value store, which is one of two layouts:

* ``"use_ocdbt": true`` (what orbax writes by default): an OCDBT database,
  tensorstore's B-tree of keys over append-only data files, whose nodes
  and zarr chunks are zstd frames (decoded by ``utils/zstd.py``);
* ``"use_ocdbt": false``: the plain layout, one file per key
  (``a.b.c/.zarray``, ``a.b.c/0.0``).

:func:`read_tree` reads both. :func:`write_tree` writes the plain layout
with uncompressed chunks, which orbax's ``StandardCheckpointer`` restores,
so no zstd encoder is needed. Anything else (zarr3, a compressor other than
zstd, filters, Fortran order, a numbered OCDBT manifest, a dtype outside
``DTYPES``) raises, naming the key; nothing is skipped or guessed.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import os.path as osp
import shutil
import struct
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ctpn_tpu_torch.utils import zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")

# zarr v2 dtype -> numpy storage dtype; bfloat16 is stored as its 16 bits
# and widened to float32 on read (exactly: a bfloat16 is the top half of
# a float32)
DTYPES = {
    "<f4": np.dtype("<f4"), "<f2": np.dtype("<f2"), "bfloat16": np.dtype("<u2"),
    "<i4": np.dtype("<i4"), "<i8": np.dtype("<i8"), "|b1": np.dtype("|b1"),
    "|u1": np.dtype("|u1"),
}
_READ_TYPES = ("np.ndarray", "jax.Array", "scalar")

Tree = Dict[str, Any]


class FormatError(ValueError):
    """A checkpoint file this reader does not accept (named in the message)."""


# ---- OCDBT -------------------------------------------------------------------
# Field layouts follow tensorstore's "OCDBT storage format" document
# (tensorstore/kvstore/ocdbt/format/, sections "Manifest format", "Version
# tree", "B+tree node format" and "Data file table"), checked against the
# files orbax 0.11 writes.

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # offset/length of an empty tree's root reference


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a decoded OCDBT body: varints (LEB128), bytes."""

    def __init__(self, data: bytes, name: str):
        self.b, self.i, self.name = data, 0, name

    def fail(self, what: str):
        raise FormatError(f"{self.name}: {what} (at byte {self.i})")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.i >= len(self.b):
                self.fail("truncated varint")
            c = self.b[self.i]
            self.i += 1
            value |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return value
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            self.fail(f"truncated: {n} bytes wanted")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self.raw(1)[0]


def _envelope(data: bytes, magic: int, name: str, limit: int) -> bytes:
    """Check the header (magic, length, version, compression) and the CRC-32C
    footer of a manifest or node; return its decoded body."""
    if len(data) < 18:
        raise FormatError(f"{name}: truncated ({len(data)} bytes)")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise FormatError(f"{name}: magic {got_magic:08x}, expected {magic:08x}")
    if length != len(data):
        raise FormatError(f"{name}: header says {length} bytes, found {len(data)}")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if _crc32c(data[:-4]) != want:
        raise FormatError(f"{name}: CRC-32C mismatch")
    r = _Reader(data[:-4], name)
    r.i = 12
    if r.varint() != 0:
        r.fail("unknown format version")
    compression = r.varint()
    body = data[r.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, name=name, limit=limit).tobytes()
    r.fail(f"unknown compression format {compression}")


def _file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """Data file table: ``(base path, full path)`` per file id, both under the
    directory of the database. ``base`` is the base path of the file the
    table was read from, which prefixes every path in it."""
    n = r.varint()
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for k in range(n):
        full = (prev[:prefix[k - 1]] if k else b"") + r.raw(suffix[k])
        prev = full
        if base_len[k] > len(full):
            r.fail("base path longer than its path")
        path = full.decode()
        if path.startswith("/") or ".." in path.split("/"):
            r.fail(f"data file path {path!r} leaves the checkpoint directory")
        files.append((base + path[:base_len[k]], base + path))
    return files


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for k in range(n):
        if k and prefix[k - 1] > len(prev):
            r.fail("key prefix longer than the previous key")
        key = (prev[:prefix[k - 1]] if k else b"") + r.raw(suffix[k])
        keys.append(key)
        prev = key
    return keys, common


class OcdbtStore:
    """The keys of an OCDBT database at its newest version: ``get(key)``
    returns the value's bytes (inline in a leaf, or a range of a data file),
    or None for a key the tree does not hold."""

    def __init__(self, root: str):
        self.root = root
        path = osp.join(root, "manifest.ocdbt")
        if not osp.exists(path):
            raise FormatError(
                f"{root}: no manifest.ocdbt (a numbered manifest, or not an "
                "OCDBT database)")
        # the body of the manifest is small; its zstd frame has a content size
        r = _Reader(_envelope(_read(path), _MANIFEST_MAGIC, path, 1 << 20), path)
        r.raw(16)  # uuid
        if r.varint() != 0:
            r.fail("numbered manifests are not read")
        r.varint()  # max_inline_value_bytes
        self.max_node = r.varint()  # max_decoded_node_bytes
        r.u8()  # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.raw(4)  # zstd level, int32le
        elif method != 0:
            r.fail(f"unknown compression method {method}")
        files = _file_table(r, "")
        # the newest versions are inline, oldest first; older ones live in
        # version tree nodes, which a reader of the newest never needs
        n = r.varint()
        if n == 0:
            r.fail("no versions")
        r.varints(n)  # generation numbers, ascending
        height = list(r.raw(n))
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        r.raw(8 * n)  # commit times
        self.values: Dict[bytes, Union[bytes, Tuple[str, int, int]]] = {}
        if off[-1] != _NO_ROOT:
            if fid[-1] >= len(files):
                r.fail(f"root in data file {fid[-1]} of {len(files)}")
            base, full = files[fid[-1]]
            self._node(base, full, off[-1], length[-1], height[-1], b"")

    def _node(self, base: str, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        name = f"{osp.join(self.root, path)}@{offset}+{length}"
        data = _read(osp.join(self.root, path), offset, length)
        r = _Reader(_envelope(data, _NODE_MAGIC, name, self.max_node), name)
        if r.u8() != height:
            r.fail(f"node height differs from its reference ({height})")
        files = _file_table(r, base)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)

        def file_ids(m):
            ids = r.varints(m)
            if any(i >= len(files) for i in ids):
                r.fail(f"data file id past the table of {len(files)}")
            return ids

        if height == 0:
            lengths = r.varints(n)
            kinds = list(r.raw(n))
            indirect = [k for k in range(n) if kinds[k] == 1]
            if any(kind > 1 for kind in kinds):
                r.fail("unknown value kind")
            ids = file_ids(len(indirect))
            offsets = r.varints(len(indirect))
            for k, i, o in zip(indirect, ids, offsets):
                self.values[prefix + keys[k]] = (files[i][1], o, lengths[k])
            for k in range(n):
                if kinds[k] == 0:
                    self.values[prefix + keys[k]] = r.raw(lengths[k])
            if r.i != len(r.b):
                r.fail("bytes after the last inline value")
            return
        ids = file_ids(n)
        offsets, lengths = r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        if r.i != len(r.b):
            r.fail("bytes after the child references")
        for k in range(n):
            if common[k] > len(keys[k]):
                r.fail("subtree prefix longer than its key")
            child_base, child_path = files[ids[k]]
            self._node(child_base, child_path, offsets[k], lengths[k], height - 1,
                       prefix + keys[k][:common[k]])

    def get(self, key: str) -> Optional[bytes]:
        ref = self.values.get(key.encode())
        if ref is None or isinstance(ref, bytes):
            return ref
        path, offset, length = ref
        return _read(osp.join(self.root, path), offset, length)


class PlainStore:
    """The plain layout: each key is a file under the directory."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        path = osp.join(self.root, *key.split("/"))
        return _read(path) if osp.isfile(path) else None


def _read(path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
    with open(path, "rb") as fh:
        fh.seek(offset)
        data = fh.read() if length is None else fh.read(length)
    if length is not None and len(data) != length:
        raise FormatError(
            f"{path}: {length} bytes wanted at {offset}, the file holds fewer")
    return data


# ---- zarr v2 -----------------------------------------------------------------


def _fill(value, dtype: np.dtype, zarr_dtype: str, name: str):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special or zarr_dtype not in ("<f4", "<f2", "bfloat16"):
            raise FormatError(f"{name}: fill_value {value!r}")
        value = special[value]
    if zarr_dtype == "bfloat16":
        return np.array([value], np.float32).view(np.uint32)[0] >> 16
    return value


def read_array(store, name: str, where: str = "") -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` (bfloat16 widened to float32)."""
    label = f"{where}:{name}" if where else name
    meta = store.get(f"{name}/.zarray")
    if meta is None:
        raise FormatError(f"{label}: no .zarray in the checkpoint")
    z = json.loads(meta)
    if z.get("zarr_format") != 2:
        raise FormatError(f"{label}: zarr_format {z.get('zarr_format')!r}, only 2 is read")
    zdt = z.get("dtype")
    if zdt not in DTYPES:
        raise FormatError(f"{label}: dtype {zdt!r} is not read")
    if z.get("order", "C") != "C":
        raise FormatError(f"{label}: order {z.get('order')!r}, only C is read")
    if z.get("filters"):
        raise FormatError(f"{label}: filters {z['filters']!r} are not read")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise FormatError(f"{label}: compressor {comp!r}, only zstd or none is read")
    sep = z.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise FormatError(f"{label}: dimension_separator {sep!r}")
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise FormatError(f"{label}: chunks {list(chunks)} for shape {list(shape)}")
    dtype = DTYPES[zdt]
    out = np.empty(shape, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    fill = _fill(z.get("fill_value"), dtype, zdt, label)
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        raw = store.get(key)
        if raw is None:  # absent chunk: every element is the fill value
            chunk = np.full(chunks, fill, dtype)
        else:
            if comp is not None:
                raw = zstd.decompress(raw, size=chunk_bytes, name=f"{where}:{key}")
            elif len(raw) != chunk_bytes:
                raise FormatError(f"{where}:{key}: {len(raw)} bytes, expected {chunk_bytes}")
            chunk = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if zdt == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


# ---- trees ---------------------------------------------------------------------


def leaf_paths(path: str) -> List[Tuple[Tuple[str, ...], str]]:
    """``(key path, value type)`` of every leaf in ``path/_METADATA``, in its
    order; key paths come from ``key_metadata`` (a sequence index is its
    decimal string)."""
    with open(osp.join(path, METADATA)) as fh:
        meta = json.load(fh)
    if meta.get("use_zarr3"):
        raise FormatError(f"{path}: zarr3 checkpoints are not read")
    out = []
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        out.append((keys, entry.get("value_metadata", {}).get("value_type", "")))
    return out


def _store(path: str):
    with open(osp.join(path, METADATA)) as fh:
        meta = json.load(fh)
    return OcdbtStore(path) if meta.get("use_ocdbt", True) else PlainStore(path)


def read_tree(path: str, select: Sequence[str] = ()) -> Tree:
    """The tree of the orbax checkpoint at ``path`` (a directory holding
    ``_METADATA``) as nested dicts of numpy arrays.

    ``select`` is a key-path prefix: only the leaves under it are read, and
    the subtree is returned (``("state", "params")`` of a JAX solver step).
    Leaves that hold no data (``None``, optax's empty states) are left out;
    any other value type raises.
    """
    if not osp.isfile(osp.join(path, METADATA)):
        raise FileNotFoundError(f"{path}: no {METADATA} (not an orbax checkpoint)")
    select = tuple(select)
    wanted = [(k, t) for k, t in leaf_paths(path) if k[:len(select)] == select]
    if not wanted:
        raise FormatError(f"{path}: no leaves under {'/'.join(select) or 'the root'}")
    store = _store(path)
    tree: Tree = {}
    for keys, vtype in wanted:
        if vtype == "None":
            continue
        if vtype not in _READ_TYPES:
            raise FormatError(f"{path}:{'.'.join(keys)}: value type {vtype!r} is not read")
        name = ".".join(keys)
        if "/" in name:  # a key path, not a path of the file system
            raise FormatError(f"{path}: leaf name {name!r} cannot be a checkpoint key")
        node = tree
        rel = keys[len(select):]
        for k in rel[:-1]:
            node = node.setdefault(k, {})
        node[rel[-1]] = read_array(store, name, path)
    return tree


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _zarr_bytes(value) -> Tuple[str, Tuple[int, ...], bytes]:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        value = t.numpy()
    a = np.require(np.asarray(value), requirements="C")  # keeps 0-d arrays 0-d
    zdt = next((k for k, d in DTYPES.items()
                if k != "bfloat16" and d == a.dtype.newbyteorder("<")), None)
    if zdt is None:
        raise FormatError(f"dtype {a.dtype} is not written")
    return zdt, a.shape, a.astype(DTYPES[zdt], copy=False).tobytes()


def write_tree(tree: Mapping[str, Any], path: str) -> str:
    """Write ``tree`` (nested dicts of numpy arrays or tensors; bfloat16
    tensors keep their 16 bits) as an orbax checkpoint at ``path`` in the
    plain layout, one uncompressed chunk per leaf.

    The directory is written under a temporary name and renamed into place,
    replacing an earlier one, so a reader never sees half a checkpoint.
    """
    path = osp.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta = {}
    for keys, value in _leaves(tree):
        name = ".".join(keys)
        if "/" in name or name.startswith("_"):
            raise FormatError(f"leaf name {name!r} cannot be a checkpoint key")
        try:
            zdt, shape, data = _zarr_bytes(value)
        except FormatError as e:
            raise FormatError(f"{name}: {e}") from None
        os.makedirs(osp.join(tmp, name))
        # one chunk per leaf (zarr wants chunk extents of at least 1)
        zarray = {"chunks": [max(d, 1) for d in shape], "compressor": None, "dimension_separator": ".",
                  "dtype": zdt, "fill_value": None, "filters": None, "order": "C",
                  "shape": list(shape), "zarr_format": 2}
        with open(osp.join(tmp, name, ".zarray"), "w") as fh:
            json.dump(zarray, fh)
        chunk = ".".join("0" * len(shape)) if shape else "0"
        if math.prod(shape):
            with open(osp.join(tmp, name, chunk), "wb") as fh:
                fh.write(data)
        tree_meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
        }
    now = time.time_ns()
    with open(osp.join(tmp, METADATA), "w") as fh:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, fh)
    with open(osp.join(tmp, CHECKPOINT_METADATA), "w") as fh:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
                   "custom_metadata": {}}, fh)
    old = f"{path}.old-{os.getpid()}"
    if osp.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path
