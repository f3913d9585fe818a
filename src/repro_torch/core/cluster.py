"""Multi-chip sharded execution: the bank axis stretched across devices.

The paper scales bulk-bitwise throughput by running one broadcast AAP
sequence on many banks at once (`core.bankgroup`); the follow-up in-DRAM
bulk-bitwise execution engine (Seshadri & Mutlu, 2019) extends the same
argument across chips and ranks — every chip adds buses, banks, and sense
amplifiers, so throughput scales with the number of chips as long as
operands never cross a chip boundary. `ChipCluster` is that layer:

  * a bulk operand's words are partitioned over ``max_chips * n_banks``
    **slots** (`shard_words`, the two-level generalization of
    `bankgroup.shard_words`): chip ``i`` holds the ``local_banks``
    contiguous slot rows ``i * local_banks ...`` as one tensor of shape
    ``(local_banks, ..., local_words)`` on its own device, laid out
    through the ``"chip"`` / ``"bank"`` rules of `dist.sharding`;
  * programs execute per chip: every chip runs the lowered
    register-machine VM (`core.lowering.execute_lowered`: the CUDA kernel
    for a chip on a card, its plain loop for a chip on the CPU) over its
    own plane block — one broadcast opcode table, per-chip data, nothing
    crosses chips during compute;
  * result readout is **gather-free per shard**: output rows come back as
    one tensor per chip, and reductions (`popcounts`) sum each chip's
    per-bank counts and combine the chips with a recursive-doubling
    **tree psum** (`tree_psum`), so only count scalars ever cross chips.

The cluster holds an explicit ``devices`` list, one entry per chip. A
device may repeat: ``["cpu"] * 8`` runs eight chips on the host, and
``["cuda:0"] * C`` runs C chips on one card.

The placement granularity is fixed at creation: words are padded to
``max_chips * n_banks`` slots regardless of the *current* chip count, so an
elastic rescale (service layer, `dist.elastic.plan_rescale`) is a pure
re-layout — a chip cluster of C chips sweeps ``max_chips // C`` slot groups
(the `sweeps` of the rescale plan's ``grad_accum``), and the bits held by
every slot are invariant across rescales.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import bankgroup, lowering
from repro_torch.core.bitplane import as_words
from repro_torch.core.commands import Program
from repro_torch.core.engine import BuddyError, RowState, _check_outputs
from repro_torch.core.timing import DDR3_1600, DramTiming
from repro_torch.dist.sharding import CLUSTER_RULES, AxisSpec, resolve_spec
from repro_torch.obs.telemetry import get_telemetry

CHIP_AXIS = "chip"
DEFAULT_PLACEMENT_CHIPS = 8

#: a sharded row: one ``(local_banks, ..., local_words)`` tensor per chip
Shards = List[torch.Tensor]


def tree_psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce sum of one tensor per chip as a recursive-doubling tree.

    log2(n) stages, each adding to chip i the value of chip i^step, moved
    to chip i's device — the butterfly the 2019 execution engine's
    inter-chip reduction network implements in hardware. When n is not a
    power of two every chip takes the plain sum. Returns one (equal) sum
    per chip, on that chip's device.
    """
    n = len(xs)
    xs = list(xs)
    if n & (n - 1):
        return [sum(x.to(xs[i].device) for x in xs) for i in range(n)]
    step = 1
    while step < n:
        xs = [xs[i] + xs[i ^ step].to(xs[i].device) for i in range(n)]
        step *= 2
    return xs


class ClusterError(BuddyError):
    pass


@dataclasses.dataclass
class ChipCluster:
    """N chips x M banks as one sharded execution domain.

    ``devices`` holds one device per chip; `max_chips * n_banks` is the
    fixed word-slot count every operand is partitioned into (`slots`), of
    which each chip holds ``local_banks = sweeps * n_banks`` contiguous
    slot rows. ``n_chips`` must divide ``max_chips`` so the re-layout
    stays a reshape.
    """

    devices: Optional[Tuple[torch.device, ...]]
    n_chips: int
    n_banks: int
    max_chips: int

    def __post_init__(self):
        if self.max_chips % self.n_chips:
            raise ClusterError(
                f"n_chips {self.n_chips} must divide placement granularity "
                f"max_chips {self.max_chips}")

    @classmethod
    def create(cls, n_chips: int, n_banks: int = 8,
               max_chips: Optional[int] = None,
               devices: Optional[Sequence] = None) -> "ChipCluster":
        """Build a cluster over ``devices[:n_chips]``.

        ``devices=None`` takes the first `n_chips` visible cards. An
        explicit list may repeat a device (``["cpu"] * 8`` on a host
        without cards). `max_chips` defaults to the smallest multiple of
        `n_chips` that is >= 8, so rescales across 1/2/4/8 chips stay pure
        re-layouts of one placement.
        """
        if devices is None:
            n_cards = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(n_cards)]
        if n_chips < 1:
            raise ClusterError(f"n_chips must be >= 1, got {n_chips}")
        if len(devices) < n_chips:
            raise ClusterError(
                f"need {n_chips} devices but only {len(devices)} are "
                f"visible; pass devices=['cpu'] * {n_chips} to run the "
                "chips on the host, or devices=['cuda:0'] * "
                f"{n_chips} to run them on one card")
        if max_chips is None:
            max_chips = n_chips * math.ceil(DEFAULT_PLACEMENT_CHIPS
                                            / n_chips)
        devs = tuple(resolve_device(d) for d in devices[:n_chips])
        return cls(devices=devs, n_chips=n_chips, n_banks=n_banks,
                   max_chips=max_chips)

    # -- layout --------------------------------------------------------------

    @property
    def sweeps(self) -> int:
        """Sequential slot groups per chip (the rescale plan's accum)."""
        return self.max_chips // self.n_chips

    @property
    def local_banks(self) -> int:
        """Slot rows resident on one chip: sweeps x physical banks."""
        return self.sweeps * self.n_banks

    @property
    def slots(self) -> int:
        """Total word-shard slots; invariant across rescale."""
        return self.max_chips * self.n_banks

    @property
    def mesh(self) -> Dict[str, int]:
        """The chip axis as `dist.sharding` reads a mesh."""
        return {CHIP_AXIS: self.n_chips}

    def spec(self, ndim: int) -> Tuple[AxisSpec, ...]:
        """Placement of a ``(chip, bank, ...)`` tensor, resolved through
        the `dist.sharding` logical-axis rules."""
        names = (CHIP_AXIS, "bank") + (None,) * (ndim - 2)
        shape = (self.n_chips, self.local_banks) + (1,) * (ndim - 2)
        return resolve_spec(shape, names, self.mesh, CLUSTER_RULES)

    def shard_words(self, x) -> Shards:
        """(..., W) operand -> one (local_banks, ..., W/slots) tensor per
        chip, on that chip's device.

        Words zero-pad up to a multiple of `slots` (zero words are inert
        for every bitwise program; `unshard_words` strips them), so uneven
        word counts shard on every layout. A tensor is split on its own
        device; a host array goes to the first chip's device first.
        """
        x = as_words(x, None if isinstance(x, torch.Tensor)
                     else self.devices[0])
        s = bankgroup.shard_words(x, self.slots)        # (slots, ..., w)
        s = s.reshape((self.n_chips, self.local_banks) + s.shape[1:])
        return [s[i].to(d) for i, d in enumerate(self.devices)]

    def unshard_words(self, shards: Sequence[torch.Tensor],
                      n_words: int) -> torch.Tensor:
        """Inverse of `shard_words`: gather the chips' shards to the first
        chip's device as (..., W)."""
        dev = self.devices[0]
        merged = torch.stack([s.to(dev) for s in shards])
        merged = merged.reshape((self.slots,) + merged.shape[2:])
        return bankgroup.unshard_words(merged, n_words)

    def local_words(self, n_words: int) -> int:
        """Per-slot word count after padding `n_words` to the slot grid."""
        return (n_words + self.slots - 1) // self.slots

    # -- sharded execution ---------------------------------------------------

    def _backend(self, backend: Optional[str], chip: int) -> str:
        """The VM a chip runs: the caller's ``backend``, else the one its
        device picks (the kernel on a card, the plain loop on the CPU)."""
        if backend is not None:
            return backend
        return "cuda" if self.devices[chip].type == "cuda" else "torch"

    def run_lowered(self, lp: lowering.LoweredProgram,
                    sharded: Dict[str, Shards], outputs: Sequence[str],
                    backend: Optional[str] = None
                    ) -> Dict[str, Shards]:
        """Execute a lowered program over already-sharded rows.

        Every row of `sharded` holds one shard per chip from
        `shard_words`; returns the requested output rows **still sharded**
        — call `unshard_words` only when a flat vector is actually needed.

        A wall-clock span when a tracing telemetry is installed
        process-wide (`repro_torch.obs.set_telemetry`; the scheduler
        installs one per batch) or a profiler runs.
        """
        tel = get_telemetry()
        if tel.spans_on():
            with tel.span("cluster.run_lowered",
                          n_chips=self.n_chips, n_banks=self.n_banks,
                          n_cmds=lp.n_cmds,
                          backend=self._backend(backend, 0)):
                return self._run_lowered(lp, sharded, outputs, backend)
        return self._run_lowered(lp, sharded, outputs, backend)

    def _run_lowered(self, lp: lowering.LoweredProgram,
                     sharded: Dict[str, Shards], outputs: Sequence[str],
                     backend: Optional[str]) -> Dict[str, Shards]:
        outputs = list(outputs)
        out: Dict[str, Shards] = {o: [] for o in outputs}
        for i in range(self.n_chips):
            local = {k: v[i] for k, v in sharded.items()}
            local_words = max(int(v.shape[-1]) for v in local.values())
            res = lowering.execute_lowered(
                lp, local, row_words=local_words, outputs=outputs,
                backend=self._backend(backend, i))
            for o in outputs:
                out[o].append(res[o])
        return out

    def popcounts(self, lp: lowering.LoweredProgram,
                  sharded: Dict[str, Shards], outputs: Sequence[str],
                  mask_shards: Sequence[torch.Tensor],
                  backend: Optional[str] = None) -> np.ndarray:
        """Masked popcount of each output row, tree-psum'd across chips.

        `mask_shards` is the catalog tail mask pushed through
        `shard_words` (padding slots are all-zero there, so pad words
        never count); singleton axes are inserted so it broadcasts over
        any inner batch (query) axes. Returns ``(n_outputs,) + batch``
        int32 counts — the only values that cross the chip boundary.

        Traced like `run_lowered`; the span also records the tree-psum
        reduction depth (``psum_hops``).
        """
        tel = get_telemetry()
        if tel.spans_on():
            hops = int(math.ceil(math.log2(self.n_chips))) \
                if self.n_chips > 1 else 0
            with tel.span("cluster.popcounts",
                          n_chips=self.n_chips, n_banks=self.n_banks,
                          n_cmds=lp.n_cmds,
                          backend=self._backend(backend, 0),
                          psum_hops=hops):
                return self._popcounts(lp, sharded, outputs, mask_shards,
                                       backend)
        return self._popcounts(lp, sharded, outputs, mask_shards, backend)

    def _popcounts(self, lp: lowering.LoweredProgram,
                   sharded: Dict[str, Shards], outputs: Sequence[str],
                   mask_shards: Sequence[torch.Tensor],
                   backend: Optional[str]) -> np.ndarray:
        outputs = list(outputs)
        per_chip: List[torch.Tensor] = []
        for i in range(self.n_chips):
            local = {k: v[i] for k, v in sharded.items()}
            local_words = max(int(v.shape[-1]) for v in local.values())
            ndim = max(v.dim() for v in local.values())
            m = mask_shards[i]
            mask = m.reshape(m.shape[:1] + (1,) * (ndim - 2) + m.shape[-1:])
            # fused count epilogue: the VM popcounts each mask-ANDed
            # output row in place (no output plane reaches device memory
            # on the card), then the chip's bank axis sums away, keeping
            # any inner batch (query) axes
            per_bank = lowering.execute_lowered(
                lp, local, row_words=local_words, outputs=outputs,
                backend=self._backend(backend, i), reduce="popcount",
                mask=mask)
            per_chip.append(torch.stack(
                [per_bank[o].to(torch.int32).sum(0, dtype=torch.int32)
                 for o in outputs]))
        return tree_psum(per_chip)[0].cpu().numpy()

    def execute(self, program: Program, data: RowState,
                outputs: Optional[List[str]] = None,
                backend: Optional[str] = None) -> RowState:
        """Cluster-parallel analog of `bankgroup.execute_banked`.

        Flat (..., W) operand rows are partitioned over chips x banks, the
        program runs once per chip on its shard, and the requested outputs
        come back reassembled to their original width on the first chip's
        device — bit-identical to `engine.execute(program, data)` for
        every program, chip count, and device.
        """
        lp = lowering.lower(program)
        if outputs is not None:
            _check_outputs(outputs, set(lp.row_names) | set(data), program)
        n_words = int(next(iter(data.values())).shape[-1])
        sharded = {k: self.shard_words(v) for k, v in data.items()}
        if outputs is None:
            out_names = [n for n in lp.row_names if n != lowering.SINK]
            out_names += [k for k in sharded if k not in out_names]
        else:
            out_names = list(outputs)
        out = self.run_lowered(lp, sharded, out_names, backend=backend)
        return {k: self.unshard_words(v, n_words) for k, v in out.items()}


_CLUSTER_CACHE: Dict[Tuple, ChipCluster] = {}


def get_cluster(n_chips: int, n_banks: int = 8,
                max_chips: Optional[int] = None,
                device="cuda") -> ChipCluster:
    """Memoized `ChipCluster.create` — the backing for one-shot dispatch
    (`engine.execute(..., n_chips=C)`). Keyed by device: on the CPU the
    chips are ``["cpu"] * n_chips``, on the card the first `n_chips`
    visible cards (`ClusterError` when there are fewer)."""
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    key = (n_chips, n_banks, max_chips, dev.type, n_cards)
    cl = _CLUSTER_CACHE.get(key)
    if cl is None:
        devices = [dev] * n_chips if dev.type == "cpu" else None
        cl = _CLUSTER_CACHE[key] = ChipCluster.create(
            n_chips, n_banks=n_banks, max_chips=max_chips, devices=devices)
    return cl


# ---------------------------------------------------------------------------
# Controller schedule across chips
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterSchedule:
    """Makespan of a bulk op split across chips (each chip: its own
    internal bus + banks, `bankgroup.pipeline_latency_ns`) plus the
    log2-depth inter-chip reduction tree for aggregate readout."""

    n_blocks: int
    n_chips: int
    n_banks: int
    compute_ns: float      # slowest chip's pipelined makespan
    reduce_ns: float       # ceil(log2 C) tree stages
    total_ns: float


def cluster_latency_ns(n_blocks: int, n_chips: int, n_banks: int,
                       program: Program,
                       timing: DramTiming = DDR3_1600,
                       xfer_ns_per_block: Optional[float] = None
                       ) -> ClusterSchedule:
    """Modeled makespan of `n_blocks` row-block ops over C chips x M banks.

    Blocks split round-robin across chips; each chip pipelines its share
    over its own internal bus and banks (transfers serialize *per chip*,
    not globally — the cross-chip seam is the whole scaling argument), and
    an aggregate readout pays one reduction-tree traversal of depth
    ceil(log2 C), one AAP-time per stage.
    """
    per_chip = [len(r) for r in
                bankgroup.partition_blocks(n_blocks, n_chips)]
    compute = max(
        (bankgroup.pipeline_latency_ns(
            blocks, n_banks, program, timing, xfer_ns_per_block).total_ns
         for blocks in per_chip if blocks),
        default=0.0)
    if xfer_ns_per_block is None:
        xfer_ns_per_block = timing.aap_ns
    reduce = math.ceil(math.log2(n_chips)) * xfer_ns_per_block \
        if n_chips > 1 else 0.0
    return ClusterSchedule(
        n_blocks=n_blocks, n_chips=n_chips, n_banks=n_banks,
        compute_ns=compute, reduce_ns=reduce, total_ns=compute + reduce)


def cluster_throughput_gbps(n_blocks: int, n_chips: int, n_banks: int,
                            program: Program,
                            timing: DramTiming = DDR3_1600) -> float:
    """End-to-end GB/s of output for a multi-block op on the cluster."""
    sched = cluster_latency_ns(n_blocks, n_chips, n_banks, program, timing)
    if sched.total_ns == 0.0:
        return 0.0
    return n_blocks * timing.row_bytes / sched.total_ns
