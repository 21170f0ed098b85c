"""Block partitions and dependent-partition derivations (host side).

JAX replacement for Legion dependent partitioning.  The reference
derives matrix (kernel) partitions and ghost (domain) partitions at runtime
with ``create_partition_by_preimage[_range]`` / ``create_partition_by_image``
over the row/col fields of the sparse matrix (reference: COOMatrix.cpp:57-141,
CSRMatrix.cpp:68-155).  Under JAX there is no runtime partitioner: all of these
index sets are computed once, on the host, with numpy, at matrix-build time,
and baked into static per-shard arrays + a static halo-exchange schedule.

This module is pure numpy (no jax) so partition semantics can be unit-tested
without any accelerator — the analog of the reference's golden partition
tests (test_all.py:19-127).

Partition model: a :class:`BlockPartition` splits ``[0, n)`` into
``num_pieces`` contiguous blocks.  Unlike Legion's ``create_equal_partition``
(which gives blocks whose sizes differ by at most one), SPMD sharding wants equal
per-device blocks, so we pad ``n`` up to a multiple of ``num_pieces`` and give
every piece exactly ``block_size`` slots; slots ``>= n`` are padding.  For
sizes divisible by the piece count (all the reference's golden cases) the two
schemes coincide exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """A disjoint + complete partition of ``[0, n)`` into equal padded blocks.

    Piece ``i`` owns global indices ``[i * block_size, (i+1) * block_size)``
    intersected with ``[0, n)``.  ``padded_size = num_pieces * block_size``.

    This is the analog of the reference's (index space, color space,
    disjoint+complete index partition) triple held by ``PartitionedVector``
    (reference: PartitionedVector.hpp:13-134, PartitionedVector.cpp:47-48).
    """

    n: int
    num_pieces: int

    def __post_init__(self) -> None:
        if self.n <= 0:
            raise ValueError(f"partition over empty space n={self.n}")
        if self.num_pieces <= 0:
            raise ValueError(f"num_pieces={self.num_pieces} must be positive")

    @property
    def block_size(self) -> int:
        return -(-self.n // self.num_pieces)

    @property
    def padded_size(self) -> int:
        return self.num_pieces * self.block_size

    def piece_bounds(self, piece: int) -> tuple[int, int]:
        """Half-open [lo, hi) of *real* (unpadded) indices owned by piece."""
        lo = piece * self.block_size
        hi = min((piece + 1) * self.block_size, self.n)
        return lo, max(lo, hi)

    def piece_size(self, piece: int) -> int:
        lo, hi = self.piece_bounds(piece)
        return hi - lo

    def piece_indices(self, piece: int) -> np.ndarray:
        """All real global indices owned by ``piece`` (golden-test hook)."""
        lo, hi = self.piece_bounds(piece)
        return np.arange(lo, hi, dtype=np.int64)

    def owner_of(self, indices: np.ndarray) -> np.ndarray:
        """Which piece owns each global index (vectorized)."""
        return np.asarray(indices, dtype=np.int64) // self.block_size

    def index_map(self) -> Dict[int, List[int]]:
        """{piece: sorted list of owned indices} — matches the format of the
        reference's golden range_partition map (test_all.py:108-127)."""
        return {p: self.piece_indices(p).tolist() for p in range(self.num_pieces)}

    def mask(self) -> np.ndarray:
        """Boolean mask of length ``padded_size``: True for real slots."""
        m = np.zeros(self.padded_size, dtype=bool)
        m[: self.n] = True
        return m


def kernel_partition_from_range(
    rows: np.ndarray, range_partition: BlockPartition
) -> List[np.ndarray]:
    """Partition the nonzero (kernel) space by row ownership.

    JAX equivalent of ``create_partition_by_preimage`` on the row field
    (reference: COOMatrix.cpp:77-95): piece ``p`` owns exactly the nonzeros
    whose row lands in piece ``p`` of the range partition.  Returns, per
    piece, the sorted array of kernel (nonzero) indices.
    """
    owners = range_partition.owner_of(rows)
    return [
        np.flatnonzero(owners == p).astype(np.int64)
        for p in range(range_partition.num_pieces)
    ]


def domain_partition_from_kernel(
    cols: np.ndarray,
    kernel_partition: Sequence[np.ndarray],
) -> List[np.ndarray]:
    """Ghost partition: the columns each kernel piece touches.

    JAX equivalent of ``create_partition_by_image`` on the col field
    (reference: COOMatrix.cpp:98-118).  The result is *aliased* (pieces
    overlap at block boundaries — the golden overlap visible in
    test_all.py:27-48): piece ``p`` is the set of source-vector entries that
    piece ``p``'s local SpMV will read, i.e. its owned block plus halo.
    """
    cols = np.asarray(cols)
    return [np.unique(cols[idx]).astype(np.int64) for idx in kernel_partition]


def range_partition_from_kernel(
    rows: np.ndarray, kernel_partition: Sequence[np.ndarray]
) -> List[np.ndarray]:
    """Rows touched by each kernel piece (``create_partition_by_image`` on the
    row field — reference: COOMatrix.cpp:121-141)."""
    rows = np.asarray(rows)
    return [np.unique(rows[idx]).astype(np.int64) for idx in kernel_partition]


def kernel_partition_from_domain(
    cols: np.ndarray, domain_partition: BlockPartition
) -> List[np.ndarray]:
    """Nonzeros whose *column* falls in each piece of the domain partition
    (``create_partition_by_preimage`` on the col field — reference:
    COOMatrix.cpp:57-74)."""
    owners = domain_partition.owner_of(cols)
    return [
        np.flatnonzero(owners == p).astype(np.int64)
        for p in range(domain_partition.num_pieces)
    ]


@dataclasses.dataclass(frozen=True)
class HaloExchange:
    """Static halo-exchange schedule for a row-partitioned matrix.

    Replaces Legion's implicit ghost-region copies (the 3rd region
    requirement of the reference's matvec launch, COOMatrix.cpp:172-188) with
    an explicit, compile-time ``ppermute`` schedule.

    For every nonzero ring offset ``d`` (delta = (dst - src) mod S), shard
    ``s`` sends ``x_local[send_idx[d][s]]`` to shard ``(s + d) % S``, which
    scatters the received buffer into its extended-x halo slots at positions
    ``recv_pos[d][dst]``.  All buffers are padded to the per-offset maximum
    count so shapes are static and identical across shards (SPMD).

    Fields (all numpy, converted to device arrays by the matvec wrapper):
      offsets:     sorted list of ring deltas d with any traffic.
      send_idx:    for each d, int array [S, max_count_d] of *local* indices
                   into the sender's block (padded with 0).
      send_count:  for each d, [S] true counts.
      recv_pos:    for each d, int array [S, max_count_d] of positions in the
                   receiver's extended-x buffer (padded with a dump slot).
      halo_size:   per shard, number of real halo slots; halo_total is the
                   padded (max over shards) halo region size.
    """

    num_pieces: int
    block_size: int
    halo_total: int
    offsets: tuple
    send_idx: Dict[int, np.ndarray]
    send_count: Dict[int, np.ndarray]
    recv_pos: Dict[int, np.ndarray]
    halo_sizes: np.ndarray  # [S]
    # For each shard: sorted array of the global column ids of its halo slots
    # (host-side metadata used to remap matrix column indices; the device
    # never sees global ids).
    halo_global: List[np.ndarray]

    @property
    def ext_size(self) -> int:
        """Length of the per-shard extended x buffer: own block, halo slots,
        and one trailing dump slot that padded scatters/gathers target."""
        return self.block_size + self.halo_total + 1


def build_halo_exchange(
    cols: np.ndarray,
    kernel_pieces: Sequence[np.ndarray],
    domain_partition: BlockPartition,
) -> HaloExchange:
    """Compute the static halo schedule for a row-partitioned matrix.

    ``kernel_pieces[p]`` lists the nonzeros owned by shard ``p`` (from
    :func:`kernel_partition_from_range`); ``cols`` is the global column array.
    The ghost image of shard ``p`` (reference: SquarePlanner.hpp:221-224) is
    ``unique(cols[kernel_pieces[p]])``; the part outside ``p``'s own domain
    block becomes halo traffic.
    """
    S = domain_partition.num_pieces
    B = domain_partition.block_size
    cols = np.asarray(cols, dtype=np.int64)

    halo_global: List[np.ndarray] = []
    for p in range(S):
        img = np.unique(cols[kernel_pieces[p]])
        lo, hi = p * B, (p + 1) * B
        halo_global.append(img[(img < lo) | (img >= hi)])

    halo_sizes = np.array([len(h) for h in halo_global], dtype=np.int64)
    halo_total = int(halo_sizes.max(initial=0))

    # traffic[d][src] = local indices src must send to dst = (src + d) % S;
    # matching positions in dst's extended buffer.
    send_lists: Dict[int, List[np.ndarray]] = {}
    recv_lists: Dict[int, List[np.ndarray]] = {}
    for dst in range(S):
        owners = domain_partition.owner_of(halo_global[dst])
        for src in np.unique(owners):
            d = int((dst - src) % S)
            sel = owners == src
            send_lists.setdefault(d, [np.empty(0, np.int64)] * S)
            recv_lists.setdefault(d, [np.empty(0, np.int64)] * S)
            # local index within src's block:
            send_lists[d] = list(send_lists[d])
            send_lists[d][src] = halo_global[dst][sel] - src * B
            # halo slot position within dst's extended buffer:
            recv_lists[d] = list(recv_lists[d])
            recv_lists[d][dst] = B + np.flatnonzero(sel).astype(np.int64)

    offsets = tuple(sorted(send_lists.keys()))
    dump = B + halo_total  # trailing dump slot for padded receives
    send_idx: Dict[int, np.ndarray] = {}
    send_count: Dict[int, np.ndarray] = {}
    recv_pos: Dict[int, np.ndarray] = {}
    for d in offsets:
        max_cnt = max(max(len(a) for a in send_lists[d]), 1)
        si = np.zeros((S, max_cnt), dtype=np.int64)
        rp = np.full((S, max_cnt), dump, dtype=np.int64)
        cnt = np.zeros(S, dtype=np.int64)
        for s in range(S):
            a = send_lists[d][s]
            si[s, : len(a)] = a
            cnt[s] = len(a)
            b = recv_lists[d][s]
            rp[s, : len(b)] = b
        send_idx[d] = si
        send_count[d] = cnt
        recv_pos[d] = rp

    return HaloExchange(
        num_pieces=S,
        block_size=B,
        halo_total=halo_total,
        offsets=offsets,
        send_idx=send_idx,
        send_count=send_count,
        recv_pos=recv_pos,
        halo_sizes=halo_sizes,
        halo_global=halo_global,
    )
