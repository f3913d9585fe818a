"""DRAM command IR: ACTIVATE / PRECHARGE micro-ops and the AAP/AP primitives.

The paper's controller expresses every bitwise operation as a sequence of
AAP(addr1, addr2) = ACTIVATE addr1; ACTIVATE addr2; PRECHARGE
AP(addr)         = ACTIVATE addr; PRECHARGE
(§5.2). No new DRAM commands are introduced — only reserved addresses.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Activate:
    addr: str


@dataclasses.dataclass(frozen=True)
class Precharge:
    pass


MicroOp = Union[Activate, Precharge]


@dataclasses.dataclass(frozen=True)
class AAP:
    """ACTIVATE-ACTIVATE-PRECHARGE. Copies result of sensing addr1 into the
    row(s) mapped to addr2 (n-wordline targets capture the negation)."""

    addr1: str
    addr2: str

    def micro_ops(self) -> Tuple[MicroOp, ...]:
        return (Activate(self.addr1), Activate(self.addr2), Precharge())


@dataclasses.dataclass(frozen=True)
class AP:
    """ACTIVATE-PRECHARGE (used when the TRA result only needs to land in the
    rows the address itself raises, e.g. AP(B14))."""

    addr: str

    def micro_ops(self) -> Tuple[MicroOp, ...]:
        return (Activate(self.addr), Precharge())


Command = Union[AAP, AP]


@dataclasses.dataclass
class Program:
    """A straight-line sequence of AAP/AP commands implementing one bulk
    bitwise operation on row-granularity operands."""

    commands: List[Command]
    comment: str = ""

    def micro_ops(self) -> Iterator[MicroOp]:
        for c in self.commands:
            yield from c.micro_ops()

    @property
    def n_aap(self) -> int:
        return sum(isinstance(c, AAP) for c in self.commands)

    @property
    def n_ap(self) -> int:
        return sum(isinstance(c, AP) for c in self.commands)

    def activates(self) -> List[str]:
        return [m.addr for m in self.micro_ops() if isinstance(m, Activate)]

    def __add__(self, other: "Program") -> "Program":
        return Program(self.commands + other.commands,
                       f"{self.comment};{other.comment}")

    def __repr__(self) -> str:
        lines = [f"Program({self.comment!r})"]
        for c in self.commands:
            if isinstance(c, AAP):
                lines.append(f"  AAP({c.addr1}, {c.addr2})")
            else:
                lines.append(f"  AP({c.addr})")
        return "\n".join(lines)


def concat(programs: Sequence[Program], comment: str = "") -> Program:
    cmds: List[Command] = []
    for p in programs:
        cmds.extend(p.commands)
    return Program(cmds, comment)
