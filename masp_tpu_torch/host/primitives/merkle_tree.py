# Copy of masp_tpu/primitives/merkle_tree.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Merkle trees of note commitments (masp_primitives/src/merkle_tree.rs).

- ``FrozenCommitmentTree``: flat-vector bulk-built tree with subtree merge
  and O(1) path extraction — the MASP addition designed for bulk/parallel
  construction (the natural TPU layout; batch hashing in ops later).
- ``CommitmentTree``: incremental append frontier (left/right/parents).
- ``IncrementalWitness``: updatable path witness.
- ``MerklePath``: auth path + position, legacy zcash serialization.
"""

from __future__ import annotations

from masp_tpu_torch.host.primitives.sapling import (
    SAPLING_COMMITMENT_TREE_DEPTH, Node,
)
from masp_tpu_torch.host.encoding import Reader, Writer

DEPTH = SAPLING_COMMITMENT_TREE_DEPTH


def _combine(level: int, a: Node, b: Node) -> Node:
    return Node.combine(level, a, b)


def _empty_root(level: int) -> Node:
    return Node.empty_root(level)


class PathFiller:
    def __init__(self, queue=None):
        self.queue = list(queue) if queue else []

    def next(self, depth: int) -> Node:
        if self.queue:
            return self.queue.pop(0)
        return _empty_root(depth)


class FrozenCommitmentTree:
    """Immutable bulk tree: flat row-major storage (merkle_tree.rs:107-256)."""

    def __init__(self, nodes: list[Node], size: int):
        self.nodes = nodes
        self._size = size

    @staticmethod
    def new(leafs: list[Node]) -> "FrozenCommitmentTree":
        tree = list(leafs)
        return FrozenCommitmentTree._complete(tree, 0, len(leafs), 0, len(leafs))

    @staticmethod
    def merge(subtrees: list["FrozenCommitmentTree"]) -> "FrozenCommitmentTree":
        if not subtrees:
            return FrozenCommitmentTree([], 0)
        if len(subtrees) == 1:
            return subtrees[0]
        size = subtrees[0].size()
        assert size & (size - 1) == 0, "full trees must be a power of two"
        for st in subtrees[:-1]:
            assert st.size() == size
        height = 0
        prev_first_start = 0
        prev_first_width = size
        prev_last_start = 0
        prev_last_width = subtrees[-1].size()
        prev_start = 0
        prev_width = (len(subtrees) - 1) * prev_first_width + prev_last_width
        leafs = prev_width
        tree: list[Node] = []
        while True:
            if prev_last_width % 2 == 1 and prev_first_width > 1:
                prev_last_width += 1
                prev_width += 1
            for st in subtrees[:-1]:
                tree.extend(st.nodes[prev_first_start : prev_first_start + prev_first_width])
            tree.extend(
                subtrees[-1].nodes[prev_last_start : prev_last_start + prev_last_width]
            )
            if prev_first_width == 1:
                break
            prev_first_start += prev_first_width
            prev_first_width //= 2
            prev_last_start += prev_last_width
            prev_last_width //= 2
            prev_start += prev_width
            prev_width //= 2
            height += 1
        return FrozenCommitmentTree._complete(tree, prev_start, prev_width, height, leafs)

    @staticmethod
    def _complete(tree, prev_start, prev_width, heightp, leafs) -> "FrozenCommitmentTree":
        import os

        # Bulk construction is the point of the Frozen tree
        # (merkle_tree.rs:107-256 builds levels in parallel): wide levels
        # hash as ONE batched device Pedersen program per level
        # (ops/pedersen_jax.batch_merkle_hash). 0 disables.
        device_min = int(os.environ.get("MASP_MERKLE_DEVICE_MIN", "64"))
        for height in range(heightp, DEPTH):
            if prev_width % 2 == 1:
                prev_width += 1
                tree.append(_empty_root(height))
            n_pairs = prev_width // 2
            if device_min > 0 and n_pairs >= device_min:
                from masp_tpu_torch.ops.pedersen import batch_merkle_hash

                pairs = [
                    (tree[prev_start + 2 * j].repr, tree[prev_start + 2 * j + 1].repr)
                    for j in range(n_pairs)
                ]
                tree.extend(Node(r) for r in batch_merkle_hash(height, pairs))
            else:
                for j in range(n_pairs):
                    tree.append(
                        _combine(height, tree[prev_start + 2 * j], tree[prev_start + 2 * j + 1])
                    )
            prev_start += prev_width
            prev_width //= 2
        return FrozenCommitmentTree(tree, leafs)

    def root(self) -> Node:
        if self.nodes:
            return self.nodes[-1]
        return _empty_root(DEPTH)

    def size(self) -> int:
        return self._size

    def path(self, pos: int) -> "MerklePath":
        auth_path = []
        start = 0
        width = self._size
        position = pos
        for height in range(DEPTH):
            if width % 2 == 1:
                width += 1
            if pos % 2 == 0:
                node = self.nodes[start + pos + 1] if pos + 1 < width else _empty_root(height)
                auth_path.append((node, False))
            else:
                node = self.nodes[start + pos - 1] if pos - 1 < width else _empty_root(height)
                auth_path.append((node, True))
            start += width
            width //= 2
            pos //= 2
        return MerklePath(auth_path, position)

    def __eq__(self, other):
        return (
            isinstance(other, FrozenCommitmentTree)
            and self.nodes == other.nodes
            and self._size == other._size
        )


class CommitmentTree:
    """Incremental frontier tree (merkle_tree.rs:276-497)."""

    def __init__(self, left=None, right=None, parents=None):
        self.left: Node | None = left
        self.right: Node | None = right
        self.parents: list[Node | None] = parents if parents is not None else []

    @staticmethod
    def empty() -> "CommitmentTree":
        return CommitmentTree()

    def size(self) -> int:
        acc = 0 if self.left is None else (1 if self.right is None else 2)
        for i, p in enumerate(self.parents):
            if p is not None:
                acc += 1 << (i + 1)
        return acc

    def _is_complete(self, depth: int) -> bool:
        if depth == 0:
            return self.left is not None and self.right is None and not self.parents
        parents = self.parents + [None] * max(0, depth - 1 - len(self.parents))
        return (
            self.left is not None
            and self.right is not None
            and all(p is not None for p in parents[: depth - 1])
        )

    def append(self, node: Node, depth: int = DEPTH) -> None:
        if self._is_complete(depth):
            raise ValueError("tree is full")
        if self.left is None:
            self.left = node
        elif self.right is None:
            self.right = node
        else:
            combined = _combine(0, self.left, self.right)
            self.left = node
            self.right = None
            for i in range(depth):
                if i < len(self.parents):
                    if self.parents[i] is not None:
                        combined = _combine(i + 1, self.parents[i], combined)
                        self.parents[i] = None
                    else:
                        self.parents[i] = combined
                        break
                else:
                    self.parents.append(combined)
                    break

    def root(self, depth: int = DEPTH, filler: PathFiller | None = None) -> Node:
        filler = filler or PathFiller()
        assert depth > 0
        leaf_root = _combine(
            0,
            self.left if self.left is not None else filler.next(0),
            self.right if self.right is not None else filler.next(0),
        )
        parents = self.parents + [None] * max(0, depth - 1 - len(self.parents))
        root = leaf_root
        for i, p in enumerate(parents[: depth - 1]):
            if p is not None:
                root = _combine(i + 1, p, root)
            else:
                root = _combine(i + 1, root, filler.next(i + 1))
        return root

    # serialization: Optional(left) Optional(right) Vector(Optional(parent))
    def write(self, w: Writer) -> None:
        for opt in (self.left, self.right):
            if opt is None:
                w.u8(0)
            else:
                w.u8(1)
                w.write(opt.repr)
        w.compact_size(len(self.parents))
        for p in self.parents:
            if p is None:
                w.u8(0)
            else:
                w.u8(1)
                w.write(p.repr)

    @staticmethod
    def read(r: Reader) -> "CommitmentTree":
        def opt_node():
            return Node(r.read(32)) if r.u8() else None

        left = opt_node()
        right = opt_node()
        n = r.compact_size()
        parents = [opt_node() for _ in range(n)]
        return CommitmentTree(left, right, parents)

    def clone(self) -> "CommitmentTree":
        return CommitmentTree(self.left, self.right, list(self.parents))

    def __eq__(self, other):
        return (
            isinstance(other, CommitmentTree)
            and self.left == other.left
            and self.right == other.right
            and self.parents == other.parents
        )


class IncrementalWitness:
    """Updatable witness (merkle_tree.rs:498-737)."""

    def __init__(self, tree: CommitmentTree, filled=None, cursor=None):
        self.tree = tree.clone()
        self.filled: list[Node] = list(filled) if filled else []
        self.cursor: CommitmentTree | None = cursor
        self.cursor_depth = self._next_depth()

    @staticmethod
    def from_tree(tree: CommitmentTree) -> "IncrementalWitness":
        w = IncrementalWitness(tree)
        w.cursor_depth = 0
        return w

    def position(self) -> int:
        return self.tree.size() - 1

    def _filler(self) -> PathFiller:
        queue = list(self.filled)
        if self.cursor is not None:
            queue.append(self.cursor.root(self.cursor_depth, PathFiller()))
        return PathFiller(queue)

    def _next_depth(self) -> int:
        skip = len(self.filled)
        if self.tree.left is None:
            if skip > 0:
                skip -= 1
            else:
                return 0
        if self.tree.right is None:
            if skip > 0:
                skip -= 1
            else:
                return 0
        d = 1
        for p in self.tree.parents:
            if p is None:
                if skip > 0:
                    skip -= 1
                else:
                    return d
            d += 1
        return d + skip

    def append(self, node: Node, depth: int = DEPTH) -> None:
        if self.cursor is not None:
            cursor = self.cursor
            self.cursor = None
            cursor.append(node, depth)
            if cursor._is_complete(self.cursor_depth):
                self.filled.append(cursor.root(self.cursor_depth, PathFiller()))
            else:
                self.cursor = cursor
        else:
            self.cursor_depth = self._next_depth()
            if self.cursor_depth >= depth:
                raise ValueError("tree is full")
            if self.cursor_depth == 0:
                self.filled.append(node)
            else:
                cursor = CommitmentTree.empty()
                cursor.append(node, depth)
                self.cursor = cursor

    def root(self, depth: int = DEPTH) -> Node:
        return self.tree.root(depth, self._filler())

    def path(self, depth: int = DEPTH) -> "MerklePath | None":
        filler = self._filler()
        auth_path = []
        if self.tree.left is not None:
            if self.tree.right is not None:
                auth_path.append((self.tree.left, True))
            else:
                auth_path.append((filler.next(0), False))
        else:
            return None
        parents = self.tree.parents + [None] * max(0, depth - 1 - len(self.tree.parents))
        for i, p in enumerate(parents[: depth - 1]):
            if p is not None:
                auth_path.append((p, True))
            else:
                auth_path.append((filler.next(i + 1), False))
        assert len(auth_path) == depth
        return MerklePath(auth_path, self.position())

    def write(self, w: Writer) -> None:
        self.tree.write(w)
        w.compact_size(len(self.filled))
        for n in self.filled:
            w.write(n.repr)
        if self.cursor is None:
            w.u8(0)
        else:
            w.u8(1)
            self.cursor.write(w)

    @staticmethod
    def read(r: Reader) -> "IncrementalWitness":
        tree = CommitmentTree.read(r)
        n = r.compact_size()
        filled = [Node(r.read(32)) for _ in range(n)]
        cursor = CommitmentTree.read(r) if r.u8() else None
        return IncrementalWitness(tree, filled, cursor)


class MerklePath:
    """Auth path (sibling, leaf_is_on_right) per level + position."""

    def __init__(self, auth_path: list[tuple[Node, bool]], position: int):
        self.auth_path = auth_path
        self.position = position

    def root(self, leaf: Node) -> Node:
        node = leaf
        for i, (sibling, on_right) in enumerate(self.auth_path):
            if on_right:
                node = _combine(i, sibling, node)
            else:
                node = _combine(i, node, sibling)
        return node

    def to_circuit_path(self) -> list[tuple[int, bool]]:
        """Format used by the Spend/Convert circuits: (sibling scalar int,
        leaf_is_on_right)."""
        return [(s.to_scalar().n, bool(b)) for (s, b) in self.auth_path]

    # legacy zcash serialization (merkle_tree.rs:790-866): depth byte, then
    # per level (reversed) 1-byte length (32) + node, then u64 LE position.
    def write(self, w: Writer) -> None:
        w.u8(len(self.auth_path))
        position = 0
        for i in range(len(self.auth_path) - 1, -1, -1):
            node, b = self.auth_path[i]
            w.u8(32)
            w.write(node.repr)
            if b:
                position |= 1 << i
        w.u64_le(position)

    @staticmethod
    def read(r: Reader) -> "MerklePath":
        """Stream deserializer (borsh impl, merkle_tree.rs:789-843): depth
        byte, depth x (len byte + 32-byte node) reversed, u64 LE position.
        Leaves trailing bytes unread (for embedding in larger records)."""
        d = r.u8()
        entries = []
        for _ in range(d):
            ln = r.u8()
            if ln != 32:
                raise ValueError("sibling node must be 32 bytes")
            entries.append(Node(r.read(32)))
        position = r.u64_le()
        entries.reverse()
        auth_path = [(n, (position >> i) & 1 == 1) for i, n in enumerate(entries)]
        return MerklePath(auth_path, position)

    @staticmethod
    def from_slice(data: bytes, depth: int = DEPTH) -> "MerklePath":
        r = Reader(data)
        path = MerklePath.read(r)
        if r.remaining():
            raise ValueError("trailing bytes in witness")
        if len(path.auth_path) != depth:
            raise ValueError("wrong path depth")
        return path

    def to_bytes(self) -> bytes:
        w = Writer()
        self.write(w)
        return w.getvalue()

    def __eq__(self, other):
        return (
            isinstance(other, MerklePath)
            and self.auth_path == other.auth_path
            and self.position == other.position
        )


__all__ = [
    "FrozenCommitmentTree", "CommitmentTree", "IncrementalWitness",
    "MerklePath", "PathFiller",
]
