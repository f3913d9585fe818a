"""TRA reliability: seeded per-cell/per-row error model + mitigation.

Triple-row activation is an analog mechanism. The 2024 characterization of
off-the-shelf DDR4 parts ("Functionally-Complete Boolean Logic in Real DRAM
Chips", arXiv:2402.18736) measured that MAJ-of-3 success rates are

  * **per-cell**: individual cells flip with different probabilities
    (process variation), modeled here as an i.i.d. per-bit flip drawn from
    a seeded generator;
  * **per-pattern**: the *operand data pattern* matters — mixed patterns
    (one or two charged cells among the three sensed) sit closer to the
    sense amplifier's metastable point and fail orders of magnitude more
    often than unanimous all-0/all-1 patterns (`pattern_scale`, indexed by
    the number of charged operands);
  * **spatially variable**: rows differ systematically (`row_sigma`, a
    deterministic lognormal factor hashed from the sensed row triple); and
  * **temperature-dependent**: error rates grow with temperature
    (`temperature_c` / `temp_coeff` around `NOMINAL_C`).

`error_planes` turns a `LoweredProgram`'s opcode table plus a seeded
`torch.Generator` into per-command, per-pattern-class XOR masks that the
VM applies **at TRA compute time** (`kernels.vm`), not on final outputs —
faulty sensed values propagate through the rest of the program exactly
like real analog failures would. The masks are indexed by command
position, so the lowering's row renumbering never changes which faults
land where.

Random bits. The port does not reproduce `jax.random`'s bits. A draw is
keyed by a tuple of ints — the service's ``(seed, group_seq)``, and each
replica appends its index, where the reference folds it into a JAX key —
and `fault_generator` seeds a `torch.Generator` on the device from that
whole tuple (`numpy.random.SeedSequence`). The same key gives the same
masks on the same device; the draw itself is sparse (a binomial count of
flips per command, class and row, then that many distinct bit positions),
so a mask costs its zero fill plus work in proportion to its faults.

Mitigation (SIMDRAM, arXiv:2012.11890, treats these margins as first-class
deployability constraints):

  * `execute_voted` — run the program k (odd) times with independent fault
    draws and take a bitwise majority over the replicas' output planes,
    reusing the MAJ-of-k kernel (`kernels.majority`, the lifted TRA
    primitive). Any fault confined to a single replica is corrected.
  * `execute_ecc` — dual-modular redundancy with a vote tie-break: run
    twice, accept on agreement (2x cost), run a third replica and majority
    vote on disagreement (3x). The catalog side of ECC (XOR parity planes
    over registered vectors) lives in `service.catalog`.

Both are surfaced as `QueryService(reliability=ReliabilityConfig(...))`
modes with modeled AAP/latency/energy overhead (`service.scheduler`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import operand_device
from repro_torch.core import lowering
from repro_torch.core.bitplane import WORD_DTYPE, as_words, i32
from repro_torch.core.lowering import KIND_TRA, LoweredProgram
from repro_torch.ops.popcount import popcount_words

#: characterization nominal temperature (°C): `temp_coeff` scales the flip
#: probability exponentially around this point
NOMINAL_C = 50.0

#: number of operand pattern classes: 0, 1, 2, or 3 charged cells sensed
N_PATTERNS = 4

RELIABILITY_MODES = ("none", "vote", "ecc")


@dataclasses.dataclass(frozen=True)
class TRAErrorModel:
    """Per-cell/per-row/per-pattern TRA flip-probability model.

    ``p_flip`` is the base per-bit flip probability of a TRA at the
    nominal temperature on a median row under the worst pattern class;
    ``pattern_scale[k]`` scales it for k charged operands (mixed patterns
    1/2 dominate, matching the 2402.18736 measurements); ``row_sigma`` is
    the std-dev of the deterministic lognormal spatial factor hashed from
    the sensed row triple; temperature scales everything by
    ``exp(temp_coeff * (temperature_c - NOMINAL_C))``.
    """

    p_flip: float = 1e-3
    pattern_scale: Tuple[float, float, float, float] = (0.05, 1.0, 1.0, 0.05)
    row_sigma: float = 0.5
    temperature_c: float = NOMINAL_C
    temp_coeff: float = 0.03

    def __post_init__(self):
        if not 0.0 <= self.p_flip <= 1.0:
            raise ValueError(f"p_flip {self.p_flip} outside [0, 1]")
        if len(self.pattern_scale) != N_PATTERNS:
            raise ValueError("pattern_scale needs one factor per pattern "
                             f"class (4), got {len(self.pattern_scale)}")

    def row_factors(self, table: np.ndarray) -> np.ndarray:
        """Deterministic per-command spatial factor (lognormal, median 1).

        Hashed from the sensed row triple, so commands activating the same
        physical rows share their factor — the model's stand-in for "this
        subarray region is weak" spatial variation.
        """
        src = np.asarray(table)[:, 1:4].astype(np.uint64)
        h = ((src[:, 0] * np.uint64(73856093))
             ^ (src[:, 1] * np.uint64(19349663))
             ^ (src[:, 2] * np.uint64(83492791)))
        out = np.empty(len(h), np.float64)
        for i, hi in enumerate(h):
            z = float(np.random.default_rng(int(hi)).standard_normal())
            out[i] = math.exp(self.row_sigma * z)
        return out

    def flip_probs(self, table: np.ndarray) -> np.ndarray:
        """(n_cmds, 4) per-command, per-pattern-class flip probabilities.

        Rows of non-TRA commands (single-wordline senses) are exactly
        zero: only the analog triple-row majority can fail.
        """
        table = np.asarray(table)
        temp = math.exp(self.temp_coeff * (self.temperature_c - NOMINAL_C))
        probs = (self.p_flip * temp
                 * self.row_factors(table)[:, None]
                 * np.asarray(self.pattern_scale, np.float64)[None, :])
        probs[(table[:, 0] & KIND_TRA) == 0] = 0.0
        return np.clip(probs, 0.0, 1.0).astype(np.float32)


def fault_generator(key: Sequence[int],
                    device: torch.device) -> torch.Generator:
    """A `torch.Generator` on ``device`` seeded from the key path
    ``(seed, group_seq, ..., replica)``.

    The port's `jax.random.fold_in` chain: `numpy.random.SeedSequence`
    hashes the whole tuple into a 63-bit seed, so every distinct path
    (another replica, another group, another seed) starts an independent
    stream, and one path always starts the same one.
    """
    words = np.random.SeedSequence([int(x) for x in key]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(words[0]) << 32) | int(words[1])) >> 1)
    return gen


def _distinct_positions(want: torch.Tensor, n: int,
                        generator: torch.Generator) -> torch.Tensor:
    """For each slot s, ``want[s]`` distinct positions drawn uniformly
    from ``range(n)``, as sorted int64 keys ``s * n + position``.

    Positions are drawn with replacement and repeats redrawn until every
    slot has its count: the first ``want[s]`` distinct values of an i.i.d.
    uniform stream form a uniformly random subset of that size. One host
    read per round; with ``want <= n / 2`` a round keeps more than half
    of its draws, so a few rounds suffice.
    """
    device = want.device
    slots = torch.arange(want.numel(), device=device)
    keys = torch.empty((0,), dtype=torch.int64, device=device)
    need = want
    while True:
        total = int(need.sum())
        if total == 0:
            return keys
        owner = torch.repeat_interleave(slots, need, output_size=total)
        pos = torch.randint(0, n, (total,), generator=generator,
                            device=device)
        keys = torch.unique(torch.cat([keys, owner * n + pos]))
        need = want - torch.bincount(keys // n, minlength=want.numel())


def error_planes(table: np.ndarray, generator: Optional[torch.Generator],
                 batch: Tuple[int, ...], row_words: int,
                 model: TRAErrorModel,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Seeded XOR fault masks: int32 ``(n_cmds, 4) + batch + (row_words,)``.

    Plane ``[i, k]`` flips the bits of command i's sensed value wherever
    the operand pattern at that bit position has k charged cells — the VM
    selects the matching class per bit at run time (data-dependent), so
    the same mask tensor reproduces the same physical fault pattern
    whatever data flows through. Every bit of plane ``[i, k]`` flips with
    probability ``flip_probs[i, k]``, independently: per (command, class,
    batch slice) a binomial count of flips over ``32 * row_words`` bits,
    then that many distinct positions (`_distinct_positions`; past half
    the bits, the positions left unflipped instead). ``p_flip == 0``
    returns exact zeros without drawing.

    The masks live on ``device`` (default: the generator's, else
    ``"cuda"``, which raises without a card), laid out
    ``batch + (n_cmds, 4, row_words)`` in memory — the VM's order, so
    `core.lowering` passes them on without a copy — and returned as a view
    in the reference's axis order.
    """
    table = np.asarray(table)
    n_cmds = int(table.shape[0])
    batch = tuple(batch)
    if device is None and generator is not None:
        device = generator.device
    device = operand_device((), device)
    n_batch = math.prod(batch)
    flat = torch.zeros((n_batch, n_cmds, N_PATTERNS, row_words),
                       dtype=WORD_DTYPE, device=device)
    view = flat.reshape(batch + (n_cmds, N_PATTERNS, row_words)).movedim(
        (-3, -2), (0, 1))
    probs = model.flip_probs(table)
    if not probs.any() or flat.numel() == 0:
        return view
    n = 32 * row_words
    p = torch.from_numpy(probs.astype(np.float64)).to(device).reshape(
        1, -1).expand(n_batch, -1).reshape(-1)    # one slot per mask row
    count = torch.binomial(torch.full_like(p, float(n)), p,
                           generator=generator).to(torch.int64)
    complement = count > n // 2
    keys = _distinct_positions(torch.where(complement, n - count, count),
                               n, generator)
    words, slot_of = torch.unique_consecutive(keys >> 5,
                                              return_inverse=True)
    bits = torch.ones_like(keys) << (keys & 31)
    vals = torch.zeros(words.shape, dtype=torch.int64,
                       device=device).index_add_(0, slot_of, bits)
    flat.view(-1)[words] = torch.where(vals >= 1 << 31, vals - (1 << 32),
                                       vals).to(WORD_DTYPE)
    if bool(complement.any()):
        rows = flat.view(-1, row_words)
        rows[complement] = ~rows[complement]
    return view


def single_fault_planes(table: np.ndarray, batch: Tuple[int, ...],
                        row_words: int, cmd: int, word: int, bit: int,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """A deterministic one-bit fault: flip bit `bit` of word `word` of
    command `cmd`'s sensed value, whatever the operand pattern is (all
    four pattern planes carry the bit, so exactly one flip happens iff the
    command is a TRA). The property suite's injection primitive. On
    ``device``, default ``"cuda"`` (raises without a card)."""
    table = np.asarray(table)
    planes = torch.zeros((int(table.shape[0]), N_PATTERNS) + tuple(batch)
                         + (row_words,), dtype=WORD_DTYPE,
                         device=operand_device((), device))
    if table[cmd, 0] & KIND_TRA:
        planes[(cmd, slice(None)) + (Ellipsis, word)] = i32(1 << bit)
    return planes


# ---------------------------------------------------------------------------
# Injected / mitigated execution over lowered programs
# ---------------------------------------------------------------------------


def _on_device(data: Dict[str, object], device
               ) -> Tuple[Dict[str, object], torch.device]:
    """``data`` with every row on the one device the call runs on, and
    that device (`_device.operand_device`): tensor rows keep theirs, host
    rows go to ``device`` (default ``"cuda"``). A value may be a row or a
    list of ``(W,)`` rows, one per batch slice."""
    def rows(v):
        return v if isinstance(v, (list, tuple)) else (v,)

    dev = operand_device([r for v in data.values() for r in rows(v)],
                         device)
    return ({k: ([as_words(r, dev) for r in v]
                 if isinstance(v, (list, tuple)) else as_words(v, dev))
             for k, v in data.items()}, dev)


def _plane_batch(data: Dict[str, object]) -> Tuple[Tuple[int, ...], int]:
    """The (batch, row_words) `lowering.execute_lowered` will derive for
    the tensor rows of ``data``."""
    shapes = [(len(v),) + tuple(v[0].shape) if isinstance(v, (list, tuple))
              else tuple(v.shape) for v in data.values()]
    return (tuple(np.broadcast_shapes(*(s[:-1] for s in shapes))),
            int(max(s[-1] for s in shapes)))


def execute_injected(lp: LoweredProgram, data: Dict[str, object],
                     outputs: Optional[List[str]] = None,
                     backend: str = "cuda",
                     model: Optional[TRAErrorModel] = None,
                     key: Optional[Sequence[int]] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """One execution with seeded TRA faults injected at compute time.

    ``key`` (default ``(0,)``) keys the draw (`fault_generator`); the VM
    runs through `lowering.execute_lowered` with ``backend``. A model
    whose probabilities are all zero passes no masks at all, which is
    bit-identical to all-zero masks. Tensor rows keep their device; host
    rows go to ``device`` (default ``"cuda"``), where the masks are drawn
    and the VM runs.
    """
    model = model or TRAErrorModel(p_flip=0.0)
    key = (0,) if key is None else tuple(key)
    data, dev = _on_device(data, device)
    errs = None
    if model.flip_probs(lp.table).any():
        batch, row_words = _plane_batch(data)
        errs = error_planes(lp.table, fault_generator(key, dev), batch,
                            row_words, model, dev)
    return lowering.execute_lowered(lp, data, outputs=outputs,
                                    backend=backend, errors=errs)


def vote_outputs(replicas: Sequence[Dict[str, torch.Tensor]],
                 outputs: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Bitwise per-plane majority across replica output dicts.

    Reuses the MAJ-of-k carry-save kernel (`kernels.ops.majority`: the
    CUDA kernel on the card, its plain version on the CPU) — the paper's
    TRA primitive lifted to k operands — so the vote itself is the same
    packed bit-plane machinery as the computation it protects.
    """
    from repro_torch.kernels import ops as kops

    k = len(replicas)
    voted: Dict[str, torch.Tensor] = {}
    for o in outputs:
        stack = torch.stack([r[o] for r in replicas])
        flat = stack.reshape(k, -1, stack.shape[-1])
        voted[o] = kops.majority(flat).reshape(stack.shape[1:])
    return voted


def _corrected_bits(replicas: Sequence[Dict[str, torch.Tensor]],
                    voted: Dict[str, torch.Tensor],
                    outputs: Sequence[str]) -> int:
    """Total replica bits the vote overrode (faults the mitigation fixed),
    summed on the device with one host read."""
    diffs = [popcount_words(r[o] ^ voted[o])
             for o in outputs for r in replicas]
    return int(torch.stack(diffs).sum()) if diffs else 0


def execute_voted(lp: LoweredProgram, data: Dict[str, object],
                  outputs: List[str], backend: str = "cuda",
                  model: Optional[TRAErrorModel] = None,
                  key: Optional[Sequence[int]] = None,
                  k: int = 3,
                  stats_out: Optional[Dict[str, int]] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """Majority-vote execution: k independent fault draws, bitwise vote.

    Replica r draws with key ``key + (r,)``. Corrects every fault confined
    to a single replica (any number of bit flips, any command).

    `stats_out` (optional dict) receives mitigation accounting when given:
    ``replicas`` run and ``corrected_bits`` (replica output bits the vote
    overrode). The counting pass costs a device diff per output plane and
    one host read, so it only runs when a dict is supplied. Host rows go
    to ``device`` as in `execute_injected`, once for all replicas.
    """
    if k < 3 or k % 2 == 0:
        raise ValueError(f"vote needs an odd k >= 3, got {k}")
    key = (0,) if key is None else tuple(key)
    data, _ = _on_device(data, device)
    replicas = [execute_injected(lp, data, outputs=outputs, backend=backend,
                                 model=model, key=key + (r,))
                for r in range(k)]
    out = vote_outputs(replicas, outputs)
    for name in replicas[0]:            # pass-through rows need no vote
        out.setdefault(name, replicas[0][name])
    if stats_out is not None:
        stats_out["replicas"] = k
        stats_out["tiebreaks"] = 0
        stats_out["corrected_bits"] = _corrected_bits(replicas, out, outputs)
    return out


def execute_ecc(lp: LoweredProgram, data: Dict[str, object],
                outputs: List[str], backend: str = "cuda",
                model: Optional[TRAErrorModel] = None,
                key: Optional[Sequence[int]] = None,
                stats_out: Optional[Dict[str, int]] = None,
                device=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """Dual-modular redundancy with a vote tie-break.

    Two replicas that agree are accepted (2x cost — the common case when
    faults are rare); a disagreement triggers a third replica and a
    bitwise majority (3x). Agreement is decided on the device, one bool
    read per output. Returns (outputs, replicas_run). `stats_out`
    (optional dict) receives ``replicas``, ``tiebreaks`` (0 or 1) and
    ``corrected_bits`` as in `execute_voted`; host rows go to ``device``
    as there.
    """
    key = (0,) if key is None else tuple(key)
    data, _ = _on_device(data, device)
    a = execute_injected(lp, data, outputs=outputs, backend=backend,
                         model=model, key=key + (0,))
    b = execute_injected(lp, data, outputs=outputs, backend=backend,
                         model=model, key=key + (1,))
    if all(torch.equal(a[o], b[o]) for o in outputs):
        if stats_out is not None:
            stats_out["replicas"] = 2
            stats_out["tiebreaks"] = 0
            stats_out["corrected_bits"] = 0
        return a, 2
    c = execute_injected(lp, data, outputs=outputs, backend=backend,
                         model=model, key=key + (2,))
    out = vote_outputs([a, b, c], outputs)
    for name in a:
        out.setdefault(name, a[name])
    if stats_out is not None:
        stats_out["replicas"] = 3
        stats_out["tiebreaks"] = 1
        stats_out["corrected_bits"] = _corrected_bits([a, b, c], out, outputs)
    return out, 3


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """How a `QueryService` computes through TRA faults.

    ``mode``:
      * ``"none"`` — trust the analog majority (the paper's assumption);
      * ``"vote"`` — every TRA-bearing plan-group runs ``k`` times with
        independent fault draws and output planes are bitwise-voted;
      * ``"ecc"`` — dual-run compare with vote tie-break, plus a catalog
        XOR-parity integrity check per batch (`Catalog.verify_parity`).

    ``model`` draws the injected faults (None = fault-free replicas: pure
    mitigation-overhead measurement); ``seed`` roots the per-group key
    chain, so a served batch is reproducible fault-for-fault.
    """

    mode: str = "none"
    k: int = 3
    model: Optional[TRAErrorModel] = None
    seed: int = 0

    def __post_init__(self):
        if self.mode not in RELIABILITY_MODES:
            raise ValueError(f"unknown reliability mode {self.mode!r}; "
                             f"expected one of {RELIABILITY_MODES}")
        if self.k < 3 or self.k % 2 == 0:
            raise ValueError(f"replica count k must be odd >= 3, "
                             f"got {self.k}")
