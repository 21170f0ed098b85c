"""Debug / observability utilities.

JAX analog of the reference's logging & debug machinery:
``print_index_partition`` (reference: LegionUtilities.cpp:24-69 +
PrintIndexTask, UtilityTasks.cpp:102-125) emits the exact line format the
reference's golden harness parses ("<name> (<piece>) <<index>>"), so output
can be diffed against the reference's EXPECTED_PARTITION_OUTPUT
(test_all.py:19-127) after sorting.  ``banner``-style registration prints use
the same "[LegionSolvers]" prefix (reference: LegionUtilities.hpp:119-121).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from ..core.partition import BlockPartition

PREFIX = "[LegionSolvers]"

PieceMap = Union[BlockPartition, Sequence[np.ndarray], Dict[int, Sequence[int]]]


def _pieces_of(partition: PieceMap) -> List[np.ndarray]:
    if isinstance(partition, BlockPartition):
        return [partition.piece_indices(p) for p in range(partition.num_pieces)]
    if isinstance(partition, dict):
        return [np.asarray(partition[k]) for k in sorted(partition)]
    return [np.asarray(p) for p in partition]


def format_index_partition(name: str, partition: PieceMap) -> List[str]:
    """Lines in the reference's PrintIndexTask format (UtilityTasks.cpp:102-125:
    one "<name> (<piece>) <<index>>" line per owned index, preceded by the
    banner from LegionUtilities.cpp:24-69)."""
    pieces = _pieces_of(partition)
    lines = [
        f"{PREFIX} Printing index partition {name} with {len(pieces)} pieces."
    ]
    for p, idx in enumerate(pieces):
        for i in np.asarray(idx).ravel():
            lines.append(f"{name} ({p}) <{int(i)}>")
    return lines


def print_index_partition(name: str, partition: PieceMap) -> None:
    for line in format_index_partition(name, partition):
        print(line)
