"""Named-bitvector catalog with DRAM row placement.

The query service operates over *named* bitvectors ("the Tuesday activity
bitmap of tenant 3", "the gender attribute bitmap"). The catalog is the
binding between those names and (a) the packed words that hold the bits
— int32 tensors on the catalog's device — and (b) where those bits live
in the modeled DRAM: each registered vector is placed into subarray rows
through `core.allocator.DramAllocator` (paper §6.2.4 OS support), so
co-registered vectors of one tenant land in one subarray and stay all-FPM
reachable while capacity lasts. For the service's "ecc" reliability mode
the catalog keeps one XOR parity plane per affinity group, updated at
registration, and `verify_parity` recomputes them as an integrity probe.

Catalog names become the D-group row names of compiled query programs, so
they must stay clear of the reserved B/C-group addresses and the compiler's
temp/canonical-input namespaces — `register` validates that.

In distributed mode (`attach_cluster`) the catalog additionally records a
`ChipPlacement` per vector: its words are sharded over the chips of a
`core.cluster.ChipCluster` and the sharded copies (one tensor per chip,
on that chip's device) are cached on the entry. Affinity groups stay
chip-local — group members share one shard layout, so corresponding
word-slots co-reside and queries over a group never move operand bits
between chips. An elastic rescale re-attaches a new cluster and re-places
every entry (slot contents are invariant; only the slot->chip assignment
changes).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Union

import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.allocator import DramAllocator, RowHandle
from repro_torch.core.bitplane import (BitVector, as_words, n_words,
                                       pack_bits, tail_mask)

# Reserved row-name patterns: B/C-group addresses, designated/DCC rows, the
# compiler's temp rows, and the planner's canonical input/output names.
_RESERVED_RE = re.compile(
    r"^(B\d+|C[01]|T[0-3]|DCC[01]|TMP\d*|IN\d+|OUT)$")
_NAME_RE = re.compile(r"^[A-Za-z_][\w./:-]*$")


class CatalogError(KeyError):
    pass


def plane_name(column: str, j: int) -> str:
    """Catalog row name of bit-plane j of a registered integer column.

    The one naming convention shared by the service (`register_column`),
    the planner (arithmetic query expansion), and range-scan lowering.
    """
    return f"{column}.b{j}"


@dataclasses.dataclass(frozen=True)
class ChipPlacement:
    """Where one bitvector's word-shards live on the chip cluster.

    In distributed mode every vector is word-partitioned over
    ``n_chips * local_banks`` slots (`core.cluster.ChipCluster`); slot s
    lives on chip ``s // local_banks``. Vectors of one affinity `group`
    share this layout, so slot s of *every* group member is resident on
    the same chip — queries over a group combine operands chip-locally
    and nothing but reduction scalars crosses the chip boundary.
    """

    n_chips: int
    local_banks: int          # slot rows resident per chip
    local_words: int          # packed words per slot (after padding)
    group: Optional[str] = None

    @property
    def slots(self) -> int:
        return self.n_chips * self.local_banks

    def chip_of_slot(self, slot: int) -> int:
        return slot // self.local_banks


@dataclasses.dataclass
class CatalogEntry:
    """One registered bitvector: packed words + modeled DRAM placement."""

    name: str
    words: torch.Tensor       # (n_words,) int32, LSB-first packed
    n_bits: int
    handle: RowHandle         # (bank, subarray, row) placement
    group: Optional[str] = None
    #: distributed mode only: the (local_banks, local_words) shard of each
    #: chip and the layout record (None until a cluster is attached)
    shards: Optional[List[torch.Tensor]] = None
    placement: Optional[ChipPlacement] = None

    @property
    def n_row_blocks(self) -> int:
        """How many 8KB DRAM rows the vector spans (>= 1)."""
        return self.handle.n_rows


@dataclasses.dataclass
class Catalog:
    """Registry of named bitvectors, placed via the DRAM allocator.

    All vectors in one catalog share a bit domain (`n_bits`) — queries
    combine arbitrary subsets of them, so mixed widths would be a silent
    correctness bug; the first registration pins the width. Every vector
    lives on `device`, the card (``"cuda"``) unless the caller asks for
    the CPU; asking for the card where there is none raises.
    """

    allocator: DramAllocator = dataclasses.field(default_factory=DramAllocator)
    device: Union[str, torch.device] = DEFAULT_DEVICE

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._entries: Dict[str, CatalogEntry] = {}
        self.n_bits: Optional[int] = None
        # integer columns: name -> bit width; planes live as ordinary
        # entries under plane_name(name, j). The planner reads this map to
        # expand arithmetic query forms (sum/+/-/<) into plane programs.
        self.columns: Dict[str, int] = {}
        self._mask: Optional[torch.Tensor] = None
        # distributed mode: the ChipCluster every entry is placed onto
        # (None = single-process catalog)
        self._cluster = None
        self._mask_shards: Optional[List[torch.Tensor]] = None
        # ECC: running XOR parity plane per affinity group (None key =
        # ungrouped), kept on the device and maintained at registration
        # time — `verify_parity` recomputes from scratch and cross-checks,
        # the integrity probe of the service's "ecc" reliability mode
        self._parity: Dict[Optional[str], torch.Tensor] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, value, n_bits: Optional[int] = None,
                 group: Optional[str] = None) -> CatalogEntry:
        """Register packed words (uint32 array, int32/uint32 tensor, or a
        BitVector) under `name`; the words move to the catalog's device.

        `group` is the allocator affinity group: vectors registered in one
        group co-locate in one subarray while rows last (all-FPM staging).
        """
        if not _NAME_RE.match(name) or _RESERVED_RE.match(name):
            raise CatalogError(f"invalid or reserved catalog name {name!r}")
        if name in self._entries:
            raise CatalogError(f"catalog name {name!r} already registered")
        if isinstance(value, BitVector):
            words, n_bits = as_words(value.words, self.device), value.n_bits
        else:
            words = as_words(value, self.device)
            if n_bits is None:
                n_bits = int(words.shape[-1]) * 32
        if words.dim() != 1 or words.shape[0] != n_words(n_bits):
            raise CatalogError(
                f"{name!r}: expected ({n_words(n_bits)},) packed words for "
                f"{n_bits} bits, got shape {tuple(words.shape)}")
        if self.n_bits is None:
            self.n_bits = n_bits
        elif n_bits != self.n_bits:
            raise CatalogError(
                f"{name!r}: domain {n_bits} != catalog domain {self.n_bits}")
        handle = self.allocator.alloc(name, n_bits, group=group)
        entry = CatalogEntry(name, words, n_bits, handle, group=group)
        self._entries[name] = entry
        prev = self._parity.get(group)
        self._parity[group] = words.clone() if prev is None \
            else prev ^ words
        if self._cluster is not None:
            self._place(entry)
        return entry

    def register_bits(self, name: str, bits, group: Optional[str] = None
                      ) -> CatalogEntry:
        """Register from a bool/0-1 bit array (packed on the device)."""
        bits = torch.as_tensor(bits).to(self.device)
        return self.register(name, pack_bits(bits), bits.shape[-1], group)

    def register_column(self, name: str, planes, n_values: int, n_bits: int,
                        group: Optional[str] = None) -> None:
        """Register an integer column: one entry per vertical bit plane.

        `planes` is the (n_bits, n_words) LSB-first plane stack of a
        `VerticalColumn`; plane j lands under `plane_name(name, j)` and the
        column's width is recorded in `self.columns` so arithmetic queries
        (`sum(name)`, `name + other`, `name < K`) can be expanded.
        """
        if name in self.columns:
            raise CatalogError(f"column {name!r} already registered")
        for j in range(n_bits):
            self.register(plane_name(name, j), planes[j], n_values,
                          group=group)
        self.columns[name] = n_bits

    # -- lookup -------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, name: str) -> CatalogEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise CatalogError(f"unknown catalog name {name!r}") from None

    def names(self) -> List[str]:
        return list(self._entries)

    def row_state(self, names: Iterable[str]) -> Dict[str, torch.Tensor]:
        """Engine-ready {row name -> words} for a subset of entries."""
        return {n: self.get(n).words for n in names}

    def mask(self) -> torch.Tensor:
        """Tail mask zeroing the padding bits of the last packed word
        (kept on the device, built once per domain)."""
        assert self.n_bits is not None, "empty catalog has no domain"
        if self._mask is None or self._mask.shape[0] != n_words(self.n_bits):
            self._mask = as_words(tail_mask(self.n_bits), self.device)
        return self._mask

    # -- ECC parity planes ----------------------------------------------------

    def parity_plane(self, group: Optional[str] = None) -> torch.Tensor:
        """The maintained XOR parity of one affinity group's vectors
        (word-level XOR over the packed words, on the catalog's device)."""
        if group not in self._parity:
            raise CatalogError(f"no vectors registered in group {group!r}")
        return self._parity[group]

    def verify_parity(self) -> bool:
        """Recompute every group's XOR parity on the device and cross-check
        the maintained planes, reading back one bool — False means some
        registered vector's words were corrupted (or parity maintenance
        has a bug)."""
        fresh: Dict[Optional[str], torch.Tensor] = {}
        for entry in self._entries.values():
            prev = fresh.get(entry.group)
            fresh[entry.group] = entry.words if prev is None \
                else prev ^ entry.words
        if set(fresh) != set(self._parity):
            return False
        if not fresh:
            return True
        bad = torch.stack([(self._parity[g] != fresh[g]).any()
                           for g in fresh])
        return not bool(bad.any())

    # -- chip placement (distributed mode) ------------------------------------

    def _place(self, entry: CatalogEntry) -> None:
        cluster = self._cluster
        entry.shards = cluster.shard_words(entry.words)
        entry.placement = ChipPlacement(
            n_chips=cluster.n_chips, local_banks=cluster.local_banks,
            local_words=int(entry.shards[0].shape[-1]), group=entry.group)

    def attach_cluster(self, cluster) -> None:
        """Place every registered vector onto a `core.cluster.ChipCluster`.

        Called at service start and again after an elastic `rescale` —
        re-placement re-shards every entry onto the new chips. The slot
        grid (`cluster.slots`) is invariant across rescales of one
        placement lineage, so the bits held by each slot never move
        between slots; only the slot->chip assignment changes.
        """
        self._cluster = cluster
        self._mask_shards = None
        for entry in self._entries.values():
            entry.shards = None     # drop the old layout before re-placing
            self._place(entry)

    @property
    def cluster(self):
        return self._cluster

    def shards(self, name: str) -> List[torch.Tensor]:
        """The (local_banks, local_words) shard of a row on each chip."""
        entry = self.get(name)
        if entry.shards is None:
            if self._cluster is None:
                raise CatalogError(
                    f"{name!r} has no chip placement: no cluster attached")
            self._place(entry)
        return entry.shards

    def placement(self, name: str) -> Optional[ChipPlacement]:
        return self.get(name).placement

    def mask_shards(self) -> List[torch.Tensor]:
        """`mask()` pushed through the cluster's word-shard layout."""
        assert self._cluster is not None, "no cluster attached"
        if self._mask_shards is None:
            self._mask_shards = self._cluster.shard_words(self.mask())
        return self._mask_shards

    # -- placement queries ----------------------------------------------------

    def psm_copies(self, srcs: Iterable[str], dst_group_rep: str) -> int:
        """Operand movements needing PSM for an op over `srcs` (§6.2.2)."""
        return self.allocator.psm_copies_for_op(list(srcs), dst_group_rep)
