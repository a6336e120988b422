"""Host-side image loading, resizing, padding, and artifact IO.

Replaces reference ``src/utils/data_io.py`` (grayscale read with
divisibility-8 resize, square padding with masks, h5 dict IO). Decoding stays
on host (cv2/PIL are data prep, not the hot path — SURVEY.md §2.4); everything
returned is a numpy array shaped for the fixed-shape device pipeline:
images are HWC float32 in [0, 1] with channel dim 1.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

try:  # cv2 is the fast path; PIL fallback keeps the module importable anywhere
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False
    from PIL import Image as _PILImage


def imread_gray(path: str) -> np.ndarray:
    """Read an image as float32 grayscale [H, W] in [0, 1]."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
    else:  # pragma: no cover
        img = np.asarray(_PILImage.open(path).convert("L"))
    return img.astype(np.float32) / 255.0


def imread_color(path: str) -> np.ndarray:
    """Read an image as uint8 RGB [H, W, 3]."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].copy()
    return np.asarray(_PILImage.open(path).convert("RGB"))  # pragma: no cover


def resize_image(
    img: np.ndarray, new_hw: Tuple[int, int]
) -> np.ndarray:
    """Resize [H, W] or [H, W, C] to (new_h, new_w) with area/linear interp."""
    h, w = img.shape[:2]
    nh, nw = new_hw
    if (h, w) == (nh, nw):
        return img
    if _HAS_CV2:
        interp = cv2.INTER_AREA if nh < h else cv2.INTER_LINEAR
        return cv2.resize(img, (nw, nh), interpolation=interp)
    arr = _PILImage.fromarray(  # pragma: no cover
        (img * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    ).resize((nw, nh))
    out = np.asarray(arr)  # pragma: no cover
    return out.astype(img.dtype) / (255.0 if img.dtype != np.uint8 else 1)


def round_to_divisible(size: int, df: int = 8) -> int:
    """Largest multiple of df not exceeding size (reference df-8 semantics)."""
    return max(df, (size // df) * df)


def load_gray_resize_divisible(
    path: str,
    resize_max: Optional[int] = None,
    df: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load grayscale, optionally cap the long side, snap H/W to df multiples.

    Mirrors the reference SfM pair loader (``loftr_coarse_dataset.py:12-76``):
    images enter LoFTR at (near-)original size but with both dimensions
    divisible by the coarse stride.

    Returns:
        img: [H', W'] float32; scale: [2] (w_orig/w_new, h_orig/h_new) to map
        matcher outputs back into original pixel coordinates.
    """
    img = imread_gray(path)
    h, w = img.shape
    if resize_max is not None and max(h, w) > resize_max:
        s = resize_max / max(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
    else:
        nh, nw = h, w
    nh, nw = round_to_divisible(nh, df), round_to_divisible(nw, df)
    out = resize_image(img, (nh, nw))
    scale = np.array([w / nw, h / nh], dtype=np.float32)
    return out, scale


def pad_to_shape(
    img: np.ndarray, hw: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad bottom/right to (H, W); return (padded, valid_mask)."""
    h, w = img.shape[:2]
    ph, pw = hw
    out = np.zeros((ph, pw) + img.shape[2:], dtype=img.dtype)
    out[:h, :w] = img
    mask = np.zeros((ph, pw), dtype=bool)
    mask[:h, :w] = True
    return out, mask


# --------------------------------------------------------------------- HDF5
# The SfM's hloc-style artifacts, written and read with struct and numpy (no
# h5py): the subset of the HDF5 File Format Specification that h5py writes by
# default. Superblock version 0 with 8-byte offsets and lengths; groups as
# symbol tables (a version-1 B-tree of type 0 over symbol table nodes, names
# in a local heap); version-1 object headers; datasets with a version-1
# dataspace, a little-endian fixed-point or IEEE float datatype, a fill value
# (version 2, undefined) and a contiguous layout (version 3), the undefined
# address for zero elements. A "/" in a name makes nested groups.

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
_LEAF_K, _NODE_K = 4, 16  # h5py's defaults: 2K entries a symbol table node, 2K children a B-tree node
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8
_HEAP_FREE_NULL = 1  # the local heap's "no free block"
_MSG_DATASPACE, _MSG_DATATYPE, _MSG_FILL, _MSG_LAYOUT, _MSG_CONTINUE, _MSG_STAB = 1, 3, 5, 8, 0x10, 0x11
# IEEE float properties by size: exponent location, exponent size, mantissa size, bias
_FLOAT_BITS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _tree(data: Dict[str, np.ndarray]) -> dict:
    """{path: array} -> nested {name: dict | array}, "/" splitting the path."""
    root: dict = {}
    for name, value in data.items():
        parts = [p for p in str(name).split("/") if p]
        if not parts:
            raise ValueError(f"HDF5 dataset name {name!r} is empty")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name!r}: {p!r} is a dataset, not a group")
        if parts[-1] in node:
            raise ValueError(f"{name!r} is written twice, or is also a group")
        node[parts[-1]] = value
    return root


def _datatype(dt: np.dtype) -> bytes:
    """Datatype message (version 1) of a little-endian numeric dtype."""
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        flags = 0x08 if dt.kind == "i" else 0  # bit 3: signed; bit 0 clear: little-endian
        return struct.pack("<BBBBIHH", 0x10, flags, 0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _FLOAT_BITS:
        eloc, esize, msize, bias = _FLOAT_BITS[dt.itemsize]
        # class 1, version 1; mantissa normalised with an implied 1 (0x20), sign bit last
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * dt.itemsize - 1, 0, dt.itemsize, 0,
                           8 * dt.itemsize, eloc, esize, 0, msize, bias)
    raise TypeError(f"HDF5 export takes float16/32/64 and (u)int8-64 arrays, not {dt}")


class _H5Writer:
    """Builds a file in memory: children before their parents, so that every
    address a header or node holds is known when it is written."""

    def __init__(self):
        self.buf = bytearray(96)  # the superblock, written last

    def put(self, b: bytes) -> int:
        """Append 8-aligned; return the address."""
        self.buf += b"\0" * (-len(self.buf) % 8)
        addr = len(self.buf)
        self.buf += b
        return addr

    def header(self, messages) -> int:
        """A version-1 object header holding ``messages`` [(type, flags, data)]."""
        body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), f) + _pad8(d) for t, f, d in messages)
        return self.put(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)

    def dataset(self, value) -> int:
        a = np.asarray(value)
        dt = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype
        dtype_msg = _datatype(dt)
        raw = np.ascontiguousarray(a, dtype=dt).tobytes()
        addr = self.put(raw) if raw else _UNDEF
        space = struct.pack(f"<BBB5x{a.ndim}Q", 1, a.ndim, 0, *a.shape)
        fill = struct.pack("<BBBB", 2, 2, 2, 0)  # late allocation, written if set, not defined
        layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))  # contiguous
        return self.header([(_MSG_DATASPACE, 0, space), (_MSG_DATATYPE, 1, dtype_msg), (_MSG_FILL, 1, fill),
                            (_MSG_LAYOUT, 0, layout)])

    def group(self, members: dict) -> Tuple[int, int, int]:
        """Write a group's members, heap, symbol table nodes and B-tree;
        return (object header, B-tree, heap) addresses."""
        names = sorted(members, key=lambda n: n.encode())
        entries = []  # (name, header address, cache type, scratch pad)
        for n in names:
            v = members[n]
            if isinstance(v, dict):
                h, tree, heap = self.group(v)
                entries.append((n, h, 1, struct.pack("<QQ", tree, heap)))
            else:
                entries.append((n, self.dataset(v), 0, bytes(16)))
        heap_data, offsets = bytearray(8), {}  # offset 0: the empty string
        for n in names:
            offsets[n] = len(heap_data)
            heap_data += _pad8(n.encode() + b"\0")
        heap = self.put(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), _HEAP_FREE_NULL, 0))
        self.buf[heap + 24:heap + 32] = struct.pack("<Q", heap + 32)  # the data segment follows
        self.buf += heap_data
        # symbol table nodes, each at most 2K entries, the sizes balanced so
        # that every node holds at least K when there are several
        children = []  # (address, heap offset of the child's last name)
        for chunk in _balanced(entries, 2 * _LEAF_K) if entries else ():
            body = b"".join(struct.pack("<QQI4x", offsets[n], h, c) + pad for n, h, c, pad in chunk)
            snod = struct.pack("<4sBxH", b"SNOD", 1, len(chunk)) + body
            children.append((self.put(snod + bytes(_SNOD_SIZE - len(snod))), offsets[chunk[-1][0]]))
        level = 0
        while True:  # B-tree levels, from the leaves up, until one node
            nodes = _balanced(children, 2 * _NODE_K)
            base = self.put(b"")
            addrs = [base + i * _TREE_SIZE for i in range(len(nodes))]
            left, parents = 0, []  # a node's first key: its left neighbour's last (the empty name first)
            for i, chunk in enumerate(nodes):
                sib = (addrs[i - 1] if i else _UNDEF, addrs[i + 1] if i + 1 < len(nodes) else _UNDEF)
                keys = [left] + [k for _, k in chunk]  # key j + 1: child j's last name
                node = struct.pack("<4sBBHQQ", b"TREE", 0, level, len(chunk), *sib)
                node += b"".join(struct.pack("<QQ", keys[j], a) for j, (a, _) in enumerate(chunk))
                node += struct.pack("<Q", keys[-1])
                self.buf += node + bytes(_TREE_SIZE - len(node))
                parents.append((addrs[i], keys[-1]))
                left = keys[-1]
            if len(parents) == 1:
                tree = parents[0][0]
                break
            children, level = parents, level + 1
        return self.header([(_MSG_STAB, 0, struct.pack("<QQ", tree, heap))]), tree, heap

    def finish(self, root: dict) -> bytes:
        h, tree, heap = self.group(root)
        sb = struct.pack("<8sBBBBBBBBHHIQQQQ", _SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0, 0,
                         _UNDEF, len(self.buf), _UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, h, 1, tree, heap)  # the root group's symbol table entry
        self.buf[:96] = sb
        return bytes(self.buf)


def _balanced(items: list, most: int) -> list:
    """``items`` in order, in the fewest chunks of at most ``most``, their
    sizes differing by at most one (one empty chunk for no items)."""
    n = max(1, -(-len(items) // most))
    q, r = divmod(len(items), n)
    out, s = [], 0
    for i in range(n):
        out.append(items[s:s + q + (i < r)])
        s += q + (i < r)
    return out


def _write_h5(tree: dict, path: str) -> None:
    blob = _H5Writer().finish(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)


class _H5Reader:
    """Reads the subset ``_H5Writer`` writes, which is also what h5py writes
    by default for these objects (its B-trees two levels deep above 256
    members); anything else raises NotImplementedError."""

    def __init__(self, buf: bytes):
        self.buf = buf
        if buf[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file (no signature at offset 0)")
        if buf[8] != 0 or buf[13] != 8 or buf[14] != 8:
            raise NotImplementedError(f"HDF5 superblock version {buf[8]} with {buf[13]}-byte offsets")
        self.root = self.u64(56 + 8)  # the root group's symbol table entry: its object header

    def u64(self, at: int) -> int:
        return struct.unpack_from("<Q", self.buf, at)[0]

    def messages(self, addr: int) -> Dict[int, bytes]:
        buf = self.buf
        if buf[addr] != 1:
            raise NotImplementedError(f"HDF5 object header version {buf[addr]} (only version 1)")
        p = addr + 16
        end, out = p + struct.unpack_from("<I", buf, addr + 8)[0], {}
        while p + 8 <= end:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
            if mtype == _MSG_CONTINUE or (flags & 0x02 and mtype in (_MSG_DATASPACE, _MSG_DATATYPE)):
                raise NotImplementedError(f"HDF5 object header with a continued or shared message ({mtype})")
            out[mtype] = buf[p + 8:p + 8 + msize]
            p += 8 + msize
        return out

    def node(self, addr: int):
        """A group as {name: ...} or a dataset as an array."""
        msgs = self.messages(addr)
        if _MSG_STAB in msgs:
            tree, heap = struct.unpack_from("<QQ", msgs[_MSG_STAB])
            if self.buf[heap:heap + 4] != b"HEAP":
                raise ValueError("HDF5 local heap signature missing")
            data = self.u64(heap + 24)
            out = {}
            for off, header in self.symbols(tree):
                end = self.buf.index(b"\0", data + off)
                out[self.buf[data + off:end].decode()] = self.node(header)
            return out
        if _MSG_LAYOUT in msgs:
            return self.dataset(msgs)
        raise NotImplementedError("HDF5 object that is neither a symbol-table group nor a dataset")

    def symbols(self, addr: int):
        """(name offset, object header) of every entry under a group B-tree node."""
        buf = self.buf
        sig, kind, level, used = struct.unpack_from("<4sBBH", buf, addr)
        if sig != b"TREE" or kind != 0:
            raise ValueError("HDF5 group B-tree node expected")
        for i in range(used):
            child = self.u64(addr + 24 + 16 * i + 8)
            if level > 0:
                yield from self.symbols(child)
                continue
            sig, n = struct.unpack_from("<4s2xH", buf, child)
            if sig != b"SNOD":
                raise ValueError("HDF5 symbol table node expected")
            for j in range(n):
                yield struct.unpack_from("<QQ", buf, child + 8 + 40 * j)

    def dataset(self, msgs: Dict[int, bytes]) -> np.ndarray:
        space, dtype_msg, layout = msgs[_MSG_DATASPACE], msgs[_MSG_DATATYPE], msgs[_MSG_LAYOUT]
        if space[0] != 1 or layout[0] != 3 or layout[1] != 1:
            raise NotImplementedError(f"HDF5 dataspace version {space[0]}, layout version {layout[0]} class "
                                      f"{layout[1]} (only 1, and 3 contiguous)")
        shape = struct.unpack_from(f"<{space[1]}Q", space, 8)
        cls, bits0, size = dtype_msg[0] & 0x0F, dtype_msg[1], struct.unpack_from("<I", dtype_msg, 4)[0]
        if cls == 0 and not bits0 & 0x01:
            dt = np.dtype(f"<{'i' if bits0 & 0x08 else 'u'}{size}")
        elif cls == 1 and not bits0 & 0x41:
            dt = np.dtype(f"<f{size}")
        else:
            raise NotImplementedError(f"HDF5 datatype of class {cls}, flags {bits0:#x} (only little-endian numbers)")
        n = int(np.prod(shape, dtype=np.int64))
        addr = struct.unpack_from("<Q", layout, 2)[0]
        if addr == _UNDEF or n == 0:  # never written: the fill value, zeros
            return np.zeros(shape, dt)
        return np.frombuffer(self.buf, dt, n, addr).reshape(shape).copy()


def _read_h5(path: str) -> dict:
    with open(path, "rb") as f:
        r = _H5Reader(f.read())
    return r.node(r.root)


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def save_h5(data: Dict[str, np.ndarray], path: str) -> None:
    """Write a flat dict of arrays to an HDF5 file (hloc-style artifacts);
    a "/" in a key makes nested groups."""
    _write_h5(_tree(data), path)


def load_h5(path: str) -> Dict[str, np.ndarray]:
    """Read every dataset of an HDF5 file as {path: array}."""
    return _flatten(_read_h5(path))


def grouped_save_h5(data: Dict[str, Dict[str, np.ndarray]], path: str) -> None:
    """Write a two-level dict {group: {key: array}} (per-image features h5)."""
    root = _tree({f"{g}/{k}": v for g, sub in data.items() for k, v in sub.items()})
    for g in data:  # a group with no datasets is still written
        node = root
        for p in [p for p in g.split("/") if p]:
            node = node.setdefault(p, {})
    _write_h5(root, path)


def grouped_load_h5(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read {group: {key: array}}: each top-level group's datasets, keyed by
    their path below it."""
    return {g: _flatten(v) for g, v in _read_h5(path).items() if isinstance(v, dict)}
