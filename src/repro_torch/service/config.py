"""Service construction + serving-policy configuration objects.

`ServiceConfig` holds the constructor keywords of `QueryService`
(deployment shape, device, reliability, fault tolerance, telemetry,
optimizer toggles) in one dataclass, plus the serving-loop policy knob
(`slo`) of `service.server.ServingLoop`:

    svc = QueryService(ServiceConfig(n_banks=8, device="cuda",
                                     slo=SloConfig(p99_ns=5e6)))

`reliability` takes a `repro_torch.core.errors.ReliabilityConfig`,
`fault_tolerance` a `repro_torch.dist.fault_tolerance.FaultTolerance`;
`n_chips` / `max_chips` shape the chip cluster of the distributed
deployment (its chips on `device`: distinct cards on "cuda", the host
repeated on "cpu").

The keyword constructor `QueryService(n_banks=8, device="cpu")` routes
every keyword through `ServiceConfig`. There is no backend knob: the VM
wrapper runs the CUDA kernel on a card and its plain version on the CPU.

`SloConfig` is the admission-control contract of the serving loop: a
modeled p99 sojourn target plus the policy applied when the modeled queue
delay projects past it ("shed" drops the newest lowest-priority work with
a `QueryShedError`, "defer" parks the lowest-priority tenants until the
backlog drains, "none" only observes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.timing import DDR3_1600, DramTiming

SHED = "shed"
DEFER = "defer"
OBSERVE = "none"


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """p99 sojourn target + breach policy for the serving loop."""

    #: modeled arrival -> completion (sojourn) p99 target, nanoseconds
    p99_ns: float = 5e6
    #: breach policy: "shed" (drop newest lowest-priority queries),
    #: "defer" (park lowest-priority tenants until the backlog drains),
    #: or "none" (observe only — gauges move, nothing is dropped)
    policy: str = SHED
    #: admit while projected sojourn <= safety * p99_ns; the headroom
    #: absorbs estimation error in the per-tick service-time EMA
    safety: float = 1.0

    def __post_init__(self):
        if self.policy not in (SHED, DEFER, OBSERVE):
            raise ValueError(f"unknown SLO policy {self.policy!r}")
        if self.p99_ns <= 0:
            raise ValueError("p99_ns must be positive")


@dataclasses.dataclass
class ServiceConfig:
    """Everything `QueryService` needs to construct a deployment.

    Field semantics are unchanged from the old keyword constructor (each
    field's docs live on the attribute of the same name in
    `service.service.QueryService`); `device` picks the torch device,
    `slo` feeds `QueryService.serve_loop()` as the default admission
    policy.
    """

    n_banks: int = 8
    timing: DramTiming = DDR3_1600
    #: torch device the catalog and every plane live on ("cuda" / "cpu";
    #: the port's counterpart of JAX's default device)
    device: str = "cuda"
    n_chips: Optional[int] = None
    max_chips: Optional[int] = None
    reliability: Optional["ReliabilityConfig"] = None  # noqa: F821
    fault_tolerance: Optional["FaultTolerance"] = None  # noqa: F821
    telemetry: Optional["Telemetry"] = None  # noqa: F821
    optimize: bool = True
    plan_cache_capacity: Optional[int] = 1024
    #: serving-loop admission policy (None = no SLO: observe-only loop)
    slo: Optional[SloConfig] = None


#: keywords whose bare-kwarg spelling is deprecated in favor of
#: ServiceConfig, as in the reference (which also names ``backend``, a
#: field the port does not have); the rest stay silent: they are stable
#: convenience keywords, not deployment shape
DEPRECATED_KWARGS = frozenset({"reliability", "fault_tolerance", "n_chips"})

CONFIG_FIELDS = frozenset(
    f.name for f in dataclasses.fields(ServiceConfig))
