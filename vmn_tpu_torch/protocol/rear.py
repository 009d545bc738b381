"""Port of `vmn_tpu.protocol.rear` (a host-only copy; byte-identical
behaviour).

The `vre` re-arrangement mini-language.

Rebuild of the reference's RearParser/RearInterval/RearPosition
(reference: ProtocolElGamalRearTool.java:608-694 `-format`/`-inter`
documentation):

* The inputs form a two-dimensional array: source i (input file),
  component j (width position); `(i,j)` selects one component.
* Ranges `s-e` (s inclusive, e exclusive) abbreviate several sources
  or components: `(0-2,1)`, `(0,0-3)`; a term with two ranges expands
  row-major.
* `x` concatenates components into one (wider) output object:
  `(0,1)x(3,2)`.
* `:` separates output descriptions: `(0,0-2):(0-1,4)` describes two
  output files.
* An interval list (`-inter`) is `s-e` descriptions separated by `:`,
  one per output file, slicing the batch axis.
"""

from __future__ import annotations

import re
from typing import List, Tuple


class RearFormatError(Exception):
    pass


_TERM = re.compile(r"^\((\d+)(?:-(\d+))?,(\d+)(?:-(\d+))?\)$")


def _expand(lo: str, hi) -> range:
    a = int(lo)
    if hi is None:
        return range(a, a + 1)
    b = int(hi)
    if b <= a:
        raise RearFormatError(f"empty range {a}-{b}")
    return range(a, b)


def parse_format(fmt: str) -> List[List[Tuple[int, int]]]:
    """Parse a `-format` string into per-output position lists.

    '(0,1)x(3,2):(0,0-2)' ->
        [[(0, 1), (3, 2)], [(0, 0), (0, 1)]]
    """
    outputs = []
    for out_desc in fmt.split(":"):
        positions: List[Tuple[int, int]] = []
        if not out_desc:
            raise RearFormatError("empty output description")
        for term in out_desc.split("x"):
            m = _TERM.match(term.strip())
            if not m:
                raise RearFormatError(f"malformed term {term!r}")
            src_lo, src_hi, comp_lo, comp_hi = m.groups()
            for i in _expand(src_lo, src_hi):
                for j in _expand(comp_lo, comp_hi):
                    positions.append((i, j))
        outputs.append(positions)
    return outputs


def parse_intervals(inter: str) -> List[Tuple[int, int]]:
    """Parse an `-inter` string: 's-e' descriptions separated by ':'."""
    out = []
    for part in inter.split(":"):
        m = re.match(r"^(\d+)-(\d+)$", part.strip())
        if not m:
            raise RearFormatError(f"malformed interval {part!r}")
        a, b = int(m.group(1)), int(m.group(2))
        if b <= a:
            raise RearFormatError(f"empty interval {part!r}")
        out.append((a, b))
    return out


# ---------------------------------------------------------- application


def components_of(bt, ciphs: bool) -> List:
    """Split a byte-tree object into width components.

    Ciphertexts ((u..),(v..)) -> [(u_j, v_j)]; other objects (public
    keys, plaintexts) -> child list (single component when width 1).
    """
    from vmn_tpu_torch.eio.bytetree import node

    if ciphs:
        u, v = bt.children
        if u.is_leaf or all(c.is_leaf for c in u.children):
            # width-1: children are elements, not components
            return [node(u, v)]
        return [
            node(u.children[j], v.children[j])
            for j in range(len(u.children))
        ]
    if bt.is_leaf:
        return [bt]
    return list(bt.children)


def join_components(comps: List, ciphs: bool):
    """Inverse of components_of: concatenate components to one object."""
    from vmn_tpu_torch.eio.bytetree import node

    if ciphs:
        if len(comps) == 1:
            return comps[0]
        return node(
            node(*[c.children[0] for c in comps]),
            node(*[c.children[1] for c in comps]),
        )
    if len(comps) == 1:
        return comps[0]
    return node(*comps)


def apply_format(fmt: str, inputs: List, ciphs: bool) -> List:
    """inputs: list of byte trees (sources).  Returns output byte
    trees per the format description."""
    table = [components_of(bt, ciphs) for bt in inputs]
    outs = []
    for positions in parse_format(fmt):
        comps = []
        for i, j in positions:
            if i >= len(table):
                raise RearFormatError(f"no input source {i}")
            if j >= len(table[i]):
                raise RearFormatError(
                    f"source {i} has no component {j}"
                )
            comps.append(table[i][j])
        outs.append(join_components(comps, ciphs))
    return outs
