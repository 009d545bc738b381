"""Port of `vmn_tpu.eio.bytetree` (a host-only copy; byte-identical behaviour).

Byte trees — the canonical serialization format of the mix-net.

Every object that crosses a process boundary (bulletin-board message, proof
transcript file, hash input for Fiat–Shamir challenges) is a *byte tree*:

    node := 0x00 | be32(#children) | child_0 | ... | child_{n-1}
    leaf := 0x01 | be32(#bytes)    | data

This matches the format of the reference stack's VCR library
(com.verificatum.eio.ByteTree; format documented in the public Verificatum
verifier specification) so that proof transcripts can cross-verify.

Integer conventions (both from the reference):
  * variable-length integers (group descriptions: p, q, g) are stored as
    minimal two's-complement big-endian byte arrays (Java
    ``BigInteger.toByteArray()`` semantics);
  * fixed-length integers (group/field elements inside arrays) are stored
    as unsigned big-endian arrays of a fixed per-group byte length.

This module is host-side Python: serialization never runs on the TPU.
The hot path — converting large batches of device-resident group elements
to byte-tree bytes — is vectorized with numpy in `vmn_tpu_torch.arith.limbs`.
"""

from __future__ import annotations

import io
import struct
from typing import Iterator, List, Sequence, Union


class ByteTreeError(Exception):
    """Raised on malformed byte-tree data."""


NODE_TAG = 0x00
LEAF_TAG = 0x01

# Refuse to parse pathological inputs.
_MAX_DEPTH = 64


class ByteTree:
    """An immutable byte tree: either a leaf with data or a node with children.

    Cheap structural container; all heavy data lives in `bytes` leaves.
    """

    __slots__ = ("_data", "_children")

    def __init__(
        self,
        data: Union[bytes, bytearray, memoryview, None] = None,
        children: Union[Sequence["ByteTree"], None] = None,
    ):
        if (data is None) == (children is None):
            raise ByteTreeError("exactly one of data/children must be given")
        if data is not None:
            self._data: Union[bytes, None] = bytes(data)
            self._children: Union[tuple, None] = None
        else:
            assert children is not None
            for c in children:
                if not isinstance(c, ByteTree):
                    raise ByteTreeError(f"child is not a ByteTree: {type(c)}")
            self._data = None
            self._children = tuple(children)

    # ---------------------------------------------------------------- shape

    @property
    def is_leaf(self) -> bool:
        return self._data is not None

    @property
    def data(self) -> bytes:
        if self._data is None:
            raise ByteTreeError("node has no data (expected leaf)")
        return self._data

    @property
    def children(self) -> tuple:
        if self._children is None:
            raise ByteTreeError("leaf has no children (expected node)")
        return self._children

    def __len__(self) -> int:
        if self.is_leaf:
            return len(self.data)
        return len(self.children)

    def __getitem__(self, i: int) -> "ByteTree":
        return self.children[i]

    def __iter__(self) -> Iterator["ByteTree"]:
        return iter(self.children)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ByteTree):
            return NotImplemented
        return self.to_bytes() == other.to_bytes()

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __repr__(self) -> str:
        if self.is_leaf:
            d = self.data
            shown = d[:16].hex() + ("…" if len(d) > 16 else "")
            return f"leaf({len(d)}:{shown})"
        return f"node({', '.join(repr(c) for c in self.children)})"

    # ------------------------------------------------------------ serialize

    def write_to(self, out) -> None:
        """Serialize into a binary stream."""
        stack: List[ByteTree] = [self]
        while stack:
            bt = stack.pop()
            if bt.__class__ is not ByteTree:
                bt.write_to(out)  # RawByteTree: one raw write
            elif bt.is_leaf:
                out.write(struct.pack(">BI", LEAF_TAG, len(bt.data)))
                out.write(bt.data)
            else:
                out.write(struct.pack(">BI", NODE_TAG, len(bt.children)))
                stack.extend(reversed(bt.children))

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    def to_hex(self) -> str:
        return self.to_bytes().hex()

    def write_file(self, path) -> None:
        with open(path, "wb") as f:
            self.write_to(f)

    def total_size(self) -> int:
        """Serialized size in bytes without serializing."""
        n = 0
        stack: List[ByteTree] = [self]
        while stack:
            bt = stack.pop()
            if bt.__class__ is not ByteTree:
                n += bt.total_size()  # RawByteTree: known length
                continue
            n += 5
            if bt.is_leaf:
                n += len(bt.data)
            else:
                stack.extend(bt.children)
        return n

    # ------------------------------------------------------------- parse

    @staticmethod
    def from_bytes(data: Union[bytes, memoryview]) -> "ByteTree":
        bt, offset = ByteTree._parse(memoryview(data), 0, 0)
        if offset != len(data):
            raise ByteTreeError(
                f"trailing bytes after byte tree: {len(data) - offset}"
            )
        return bt

    @staticmethod
    def from_hex(hexstr: str) -> "ByteTree":
        return ByteTree.from_bytes(bytes.fromhex(hexstr))

    @staticmethod
    def read_file(path) -> "ByteTree":
        with open(path, "rb") as f:
            return ByteTree.from_bytes(f.read())

    @staticmethod
    def _parse(mv: memoryview, offset: int, depth: int):
        if depth > _MAX_DEPTH:
            raise ByteTreeError("byte tree too deep")
        if offset + 5 > len(mv):
            raise ByteTreeError("truncated byte-tree header")
        tag = mv[offset]
        (count,) = struct.unpack_from(">I", mv, offset + 1)
        offset += 5
        if tag == LEAF_TAG:
            if offset + count > len(mv):
                raise ByteTreeError("truncated leaf data")
            return ByteTree(data=bytes(mv[offset : offset + count])), offset + count
        if tag == NODE_TAG:
            children = []
            for _ in range(count):
                child, offset = ByteTree._parse(mv, offset, depth + 1)
                children.append(child)
            return ByteTree(children=children), offset
        raise ByteTreeError(f"invalid byte-tree tag {tag}")

    # --------------------------------------------------------- convenience

    def to_int_signed(self) -> int:
        """Leaf as minimal two's-complement big-endian integer."""
        return int.from_bytes(self.data, "big", signed=True)

    def to_int_unsigned(self) -> int:
        return int.from_bytes(self.data, "big", signed=False)

    def to_u32(self) -> int:
        if len(self.data) != 4:
            raise ByteTreeError("expected 4-byte integer leaf")
        return int.from_bytes(self.data, "big", signed=False)

    def to_string(self) -> str:
        return self.data.decode("utf-8")

    def pretty(self, indent: int = 0) -> str:
        """Human-readable JSON-like dump (the `vbt` tool equivalent)."""
        pad = "  " * indent
        if self.is_leaf:
            return f'{pad}"{self.data.hex()}"'
        inner = ",\n".join(c.pretty(indent + 1) for c in self.children)
        return f"{pad}[\n{inner}\n{pad}]"


class RawByteTree(ByteTree):
    """A byte tree held in serialized form, parsed lazily and
    RECURSIVELY: child access slices the raw buffer into child
    RawByteTrees (zero-copy memoryviews), so a transcript file is never
    expanded into per-leaf Python objects.  Large uniform arrays are
    consumed directly from the raw bytes by `parse_uniform_array` /
    `parse_ec_point_array` (native C++ or one numpy pass).

    Construction does NOT validate the bytes — use `lazy_from_bytes`
    for untrusted input (one linear native scan), or rely on the
    ByteTreeError raised lazily on first inconsistent access.
    """

    __slots__ = ("_raw",)

    def __init__(self, raw):
        if not isinstance(raw, memoryview):
            raw = memoryview(raw if isinstance(raw, bytes) else bytes(raw))
        if len(raw) < 5:
            raise ByteTreeError("truncated byte-tree header")
        self._raw = raw
        self._data = None
        self._children = None

    @property
    def is_leaf(self) -> bool:
        return self._raw[0] == LEAF_TAG

    @property
    def data(self) -> bytes:
        if self._raw[0] != LEAF_TAG:
            raise ByteTreeError("node has no data (expected leaf)")
        if self._data is None:
            (count,) = struct.unpack_from(">I", self._raw, 1)
            if 5 + count != len(self._raw):
                raise ByteTreeError("truncated leaf data")
            self._data = bytes(self._raw[5:])
        return self._data

    @property
    def children(self) -> tuple:
        if self._raw[0] != NODE_TAG:
            raise ByteTreeError("leaf has no children (expected node)")
        if self._children is None:
            mv = self._raw
            (count,) = struct.unpack_from(">I", mv, 1)
            offs = _child_offsets(mv, count)
            if offs[count] != len(mv):
                raise ByteTreeError(
                    f"trailing bytes after byte tree: "
                    f"{len(mv) - offs[count]}"
                )
            self._children = tuple(
                RawByteTree(mv[offs[i]:offs[i + 1]])
                for i in range(count)
            )
        return self._children

    def write_to(self, out) -> None:
        out.write(self._raw)

    def to_bytes(self) -> bytes:
        return bytes(self._raw)

    def total_size(self) -> int:
        return len(self._raw)


def _child_offsets(mv: memoryview, count: int):
    """Start offsets of a node's children plus the node end offset
    (count+1 entries) — ONE native scan instead of count calls."""
    lib = _native()
    if lib is not None:
        import numpy as np

        base = np.frombuffer(mv, dtype=np.uint8)
        out = np.empty(count + 1, dtype=np.uint64)
        got = lib.bt_child_offsets(
            base.ctypes.data_as(ctypes.c_char_p), len(mv),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ulonglong)),
            count + 1,
        )
        if got == -2:
            raise ByteTreeError("byte tree too deep")
        if got < 0:
            raise ByteTreeError("malformed byte tree")
        return out.astype(np.int64)
    offs = []
    off = 5
    for _ in range(count):
        offs.append(off)
        off = _subtree_end(mv, off)
    offs.append(off)
    return offs


def _subtree_end(mv: memoryview, start: int) -> int:
    """End offset of the subtree at `start` (native scan when
    available; iterative Python fallback with the same depth cap)."""
    lib = _native()
    if lib is not None:
        import numpy as np

        base = np.frombuffer(mv, dtype=np.uint8)
        end = lib.bt_subtree_end(
            base.ctypes.data_as(ctypes.c_char_p), len(mv), start
        )
        if end == -2:
            raise ByteTreeError("byte tree too deep")
        if end < 0:
            raise ByteTreeError("malformed byte tree")
        return int(end)
    n = len(mv)
    off = start
    stack = [1]
    while stack:
        if stack[-1] == 0:
            stack.pop()
            continue
        stack[-1] -= 1
        if off + 5 > n:
            raise ByteTreeError("truncated byte-tree header")
        tag = mv[off]
        (count,) = struct.unpack_from(">I", mv, off + 1)
        off += 5
        if tag == LEAF_TAG:
            if off + count > n:
                raise ByteTreeError("truncated leaf data")
            off += count
        elif tag == NODE_TAG:
            if len(stack) >= _MAX_DEPTH:
                raise ByteTreeError("byte tree too deep")
            stack.append(count)
        else:
            raise ByteTreeError(f"invalid byte-tree tag {tag}")
    return off


def lazy_from_bytes(raw) -> RawByteTree:
    """Validate `raw` as ONE well-formed byte tree (single linear scan,
    no object construction) and wrap it lazily.  The hot path for
    reading transcript files: a 16k-element EC array parses ~30x faster
    than the eager per-node parser."""
    mv = memoryview(raw if isinstance(raw, bytes) else bytes(raw))
    end = _subtree_end(mv, 0)
    if end != len(mv):
        raise ByteTreeError(
            f"trailing bytes after byte tree: {len(mv) - end}"
        )
    return RawByteTree(mv)


def array_leaf_node(elems) -> RawByteTree:
    """(n, eb) uint8 matrix -> node of n uniform eb-byte leaves,
    serialized in one pass (native C++ when available, numpy strided
    assembly otherwise)."""
    import numpy as np

    elems = np.ascontiguousarray(elems, dtype=np.uint8)
    n, eb = elems.shape
    lib = _native()
    if lib is not None:
        out = ctypes.create_string_buffer(lib.bt_encoded_size(n, eb))
        written = lib.bt_encode_array(
            elems.tobytes(), n, eb, out
        )
        return RawByteTree(out.raw[:written])
    # numpy fallback: build the record array [tag|len|payload] per row
    rec = np.zeros((n, 5 + eb), dtype=np.uint8)
    rec[:, 0] = LEAF_TAG
    rec[:, 1:5] = np.frombuffer(
        struct.pack(">I", eb), dtype=np.uint8
    )
    rec[:, 5:] = elems
    head = struct.pack(">BI", NODE_TAG, n)
    return RawByteTree(head + rec.tobytes())


def parse_uniform_array(bt: ByteTree):
    """If `bt` is a node of uniform-length leaves, return an (n, eb)
    uint8 matrix; otherwise None.  One-pass native/numpy parse when the
    input is a RawByteTree."""
    import numpy as np

    if isinstance(bt, RawByteTree):
        raw = bt._raw
        base = np.frombuffer(raw, dtype=np.uint8)
        ptr = base.ctypes.data_as(ctypes.c_char_p)
        lib = _native()
        if lib is not None:
            n = ctypes.c_size_t()
            eb = ctypes.c_size_t()
            if lib.bt_probe_array(ptr, len(raw), ctypes.byref(n),
                                  ctypes.byref(eb)) == 0:
                out = ctypes.create_string_buffer(n.value * eb.value)
                got_n = ctypes.c_size_t()
                if lib.bt_decode_array(ptr, len(raw), eb.value, out,
                                       ctypes.byref(got_n)) == 0:
                    return np.frombuffer(
                        out.raw, dtype=np.uint8
                    ).reshape(n.value, eb.value)
        # numpy fallback on raw bytes
        if len(raw) >= 10 and raw[0] == NODE_TAG and raw[5] == LEAF_TAG:
            (n,) = struct.unpack_from(">I", raw, 1)
            (eb,) = struct.unpack_from(">I", raw, 6)
            if len(raw) == 5 + n * (5 + eb):
                rec = np.frombuffer(
                    raw, dtype=np.uint8, offset=5
                ).reshape(n, 5 + eb)
                if (rec[:, 0] == LEAF_TAG).all():
                    return np.ascontiguousarray(rec[:, 5:])
        return None
    if bt.is_leaf or not bt.children:
        return None
    kids = bt.children
    if not all(c.is_leaf for c in kids):
        return None
    eb = len(kids[0].data)
    if any(len(c.data) != eb for c in kids):
        return None
    return np.frombuffer(
        b"".join(c.data for c in kids), dtype=np.uint8
    ).reshape(len(kids), eb)


def _native():
    try:
        from vmn_tpu_torch.native.build import get_lib

        return get_lib()
    except Exception:  # pragma: no cover - defensive
        return None


import ctypes  # noqa: E402


# ----------------------------------------------------------------- builders


def leaf(data: Union[bytes, bytearray, memoryview]) -> ByteTree:
    return ByteTree(data=data)


def node(*children: ByteTree) -> ByteTree:
    if len(children) == 1 and isinstance(children[0], (list, tuple)):
        children = tuple(children[0])
    return ByteTree(children=children)


def int_leaf(value: int) -> ByteTree:
    """4-byte big-endian integer leaf (ByteTree.intToByteTree equivalent)."""
    return ByteTree(data=struct.pack(">i", value))


def string_leaf(s: str) -> ByteTree:
    """UTF-8 string leaf (ExtIO.getBytes equivalent)."""
    return ByteTree(data=s.encode("utf-8"))


def signed_int_leaf(value: int) -> ByteTree:
    """Minimal two's-complement big-endian integer leaf.

    Matches Java ``BigInteger.toByteArray()``: the representation always
    carries a sign bit, so e.g. 255 encodes as ``00 ff``.
    """
    nbytes = (value.bit_length() // 8) + 1  # room for sign bit
    return ByteTree(data=value.to_bytes(nbytes, "big", signed=True))


def fixed_int_leaf(value: int, nbytes: int) -> ByteTree:
    """Unsigned big-endian integer leaf of a fixed byte length."""
    return ByteTree(data=value.to_bytes(nbytes, "big", signed=False))


def ec_points_node(xb, yb) -> RawByteTree:
    """(n, fb) x/y coordinate byte matrices -> node of n
    node(leaf(x), leaf(y)) point trees, serialized in one numpy pass
    (the per-point Python loop dominated EC transcript exports)."""
    import numpy as np

    xb = np.ascontiguousarray(xb, dtype=np.uint8)
    yb = np.ascontiguousarray(yb, dtype=np.uint8)
    n, fb = xb.shape
    rec = np.zeros((n, 5 + 2 * (5 + fb)), dtype=np.uint8)
    rec[:, 0] = NODE_TAG
    rec[:, 1:5] = np.frombuffer(struct.pack(">I", 2), dtype=np.uint8)
    rec[:, 5] = LEAF_TAG
    rec[:, 6:10] = np.frombuffer(struct.pack(">I", fb), dtype=np.uint8)
    rec[:, 10:10 + fb] = xb
    off = 10 + fb
    rec[:, off] = LEAF_TAG
    rec[:, off + 1:off + 5] = np.frombuffer(
        struct.pack(">I", fb), dtype=np.uint8
    )
    rec[:, off + 5:] = yb
    head = struct.pack(">BI", NODE_TAG, n)
    return RawByteTree(head + rec.tobytes())


def parse_ec_point_array(bt: ByteTree, fb: int):
    """If `bt` is a node of n uniform node(leaf(x), leaf(y)) points with
    fb-byte coordinates, return ((n, fb) xb, (n, fb) yb); else None."""
    import numpy as np

    rec_len = 5 + 2 * (5 + fb)
    if isinstance(bt, RawByteTree):
        raw = bt._raw
        if len(raw) < 5 or raw[0] != NODE_TAG:
            return None
        (n,) = struct.unpack_from(">I", raw, 1)
        if len(raw) != 5 + n * rec_len:
            return None
        rec = np.frombuffer(raw, np.uint8, offset=5).reshape(n, rec_len)
    else:
        if bt.is_leaf or not bt.children:
            return None
        kids = bt.children
        ok = all(
            (not k.is_leaf) and len(k.children) == 2
            and k.children[0].is_leaf and k.children[1].is_leaf
            and len(k.children[0].data) == fb
            and len(k.children[1].data) == fb
            for k in kids
        )
        if not ok:
            return None
        buf = b"".join(
            k.children[0].data + k.children[1].data for k in kids
        )
        flat = np.frombuffer(buf, np.uint8).reshape(len(kids), 2 * fb)
        return (
            np.ascontiguousarray(flat[:, :fb]),
            np.ascontiguousarray(flat[:, fb:]),
        )
    hdr_ok = (
        (rec[:, 0] == NODE_TAG).all()
        and (rec[:, 5] == LEAF_TAG).all()
        and (rec[:, 10 + fb] == LEAF_TAG).all()
    )
    if not hdr_ok:
        return None
    return (
        np.ascontiguousarray(rec[:, 10:10 + fb]),
        np.ascontiguousarray(rec[:, 10 + fb + 5:]),
    )
