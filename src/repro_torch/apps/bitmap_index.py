"""Bitmap-index analytics (paper §8.1).

The workload is the paper's real-application query [21]: per-user activity
bitmaps tracked per day, plus attribute bitmaps (e.g. gender). The query

  "How many unique users were active every week for the past n weeks?
   How many male users were active each of the past n weeks?"

executes 6n ORs (7 daily bitmaps -> weekly), 2n-1 ANDs, n+1 bitcounts.
Functional execution runs on the packed ops layer: each OR / AND through
the fused bitwise kernel and each bitcount through the popcount kernel on
the card (their plain versions on the CPU). End-to-end time comes from
`apps.cost` for baseline CPU vs Buddy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch._device import operand_device
from repro_torch.apps.cost import DEFAULT_APP_SYSTEM, AppSystem
from repro_torch.core.bitplane import pack_bits
from repro_torch.ops.bitwise import bitwise_and, bitwise_or


@dataclasses.dataclass
class UserDatabase:
    """m users; daily activity bitmaps for 7n days; gender bitmap."""

    daily: torch.Tensor      # (n_weeks, 7, m_words) int32 words
    male: torch.Tensor       # (m_words,) int32 words
    m_users: int

    @classmethod
    def synthetic(cls, m_users: int, n_weeks: int, p_active: float = 0.3,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> "UserDatabase":
        """Bernoulli(p_active) daily activity and Bernoulli(0.5) gender,
        drawn on ``device`` (default ``"cuda"``) from ``generator`` (a
        `torch.Generator` on that device; one seeded with 0 when None).
        The draws are not the reference's `jax.random` bits: carry a
        reference database across with
        `convert.user_database_from_reference` to compare the two."""
        dev = operand_device((), device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        # one day at a time: the float draws of a whole database would
        # take 4 bytes per user-day
        days = [pack_bits(torch.rand(m_users, generator=generator,
                                     device=dev) < p_active)
                for _ in range(n_weeks * 7)]
        daily = torch.stack(days).reshape(n_weeks, 7, -1)
        male = pack_bits(torch.rand(m_users, generator=generator,
                                    device=dev) < 0.5)
        return cls(daily, male, m_users)


def weekly_active_query(db: UserDatabase
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Returns (n_active_every_week, per-week male actives, op counts).

    The counts are int64 on the database's device; the reference's are
    int32 with the same values."""
    from repro_torch.kernels import ops as kops

    n_weeks = db.daily.shape[0]
    ops = {"or": 0, "and": 0, "bitcount": 0}

    weekly: List[torch.Tensor] = []
    for w in range(n_weeks):
        acc = db.daily[w, 0]
        for d in range(1, 7):
            acc = bitwise_or(acc, db.daily[w, d])
            ops["or"] += 1
        weekly.append(acc)

    every_week = weekly[0]
    for w in range(1, n_weeks):
        every_week = bitwise_and(every_week, weekly[w])
        ops["and"] += 1
    n_every = kops.popcount(every_week)
    ops["bitcount"] += 1

    male_counts = []
    for w in range(n_weeks):
        mw = bitwise_and(weekly[w], db.male)
        ops["and"] += 1
        male_counts.append(kops.popcount(mw))
        ops["bitcount"] += 1

    assert ops["or"] == 6 * n_weeks
    assert ops["and"] == 2 * n_weeks - 1
    assert ops["bitcount"] == n_weeks + 1
    return n_every, torch.stack(male_counts), ops


# ---------------------------------------------------------------------------
# Service-client path: the same query served by repro_torch.service
# ---------------------------------------------------------------------------


def week_or(w: int, prefix: str = "") -> str:
    """The 7-day OR-tree query template for week `w`.

    One definition shared by the app client below and the synthetic stream
    (`repro_torch.service.workload`): the plan-cache sharing between those
    two paths depends on the template staying structurally identical.
    """
    return "(" + " | ".join(f"{prefix}w{w}d{d}" for d in range(7)) + ")"


def build_query_service(db: UserDatabase, n_banks: int = 8):
    """Register the database's bitmaps in a fresh `QueryService` catalog
    on the database's device.

    Daily activity bitmaps become rows `w{week}d{day}`, the attribute
    bitmap becomes `male`; all co-located in one allocator affinity group
    (they participate in every query together — §6.2.4 placement).
    """
    from repro_torch.service import QueryService, ServiceConfig

    svc = QueryService(ServiceConfig(n_banks=n_banks,
                                     device=str(db.daily.device)))
    n_weeks = db.daily.shape[0]
    for w in range(n_weeks):
        for d in range(7):
            svc.register(f"w{w}d{d}", db.daily[w, d], db.m_users,
                         group="bitmaps")
    svc.register("male", db.male, db.m_users, group="bitmaps")
    return svc


def weekly_active_query_service(db: UserDatabase, svc=None, n_banks: int = 8
                                ) -> Tuple[int, torch.Tensor, Dict]:
    """§8.1 query as a *service client*: one batch of catalog queries.

    The n+1 aggregates go through the planner/plan-cache/scheduler stack
    instead of direct functional calls — same workload, service path. The
    per-week male filters share one canonical plan, so n-1 of them are plan
    cache hits inside a single batch. Results equal `weekly_active_query`.

    Returns (n_active_every_week, per-week male actives as an int64 CPU
    tensor, service stats).
    """
    from repro_torch.service import Query

    if svc is None:
        svc = build_query_service(db, n_banks)
    n_weeks = db.daily.shape[0]
    every = " & ".join(week_or(w) for w in range(n_weeks))
    batch = [Query(every, tenant="analytics")]
    batch += [Query(f"{week_or(w)} & male", tenant="analytics")
              for w in range(n_weeks)]
    rep = svc.query_batch(batch)
    n_every = rep.results[0].value
    male_counts = torch.tensor([r.value for r in rep.results[1:]],
                               dtype=torch.int64)
    return n_every, male_counts, svc.stats()


# ---------------------------------------------------------------------------
# End-to-end time model (Fig. 10)
# ---------------------------------------------------------------------------


def query_time_ns(m_users: int, n_weeks: int, use_buddy: bool,
                  sys: AppSystem = DEFAULT_APP_SYSTEM) -> float:
    n_or = 6 * n_weeks
    n_and = 2 * n_weeks - 1
    n_cnt = n_weeks + 1
    if use_buddy:
        t_ops = n_or * sys.buddy_op_ns("or", m_users) \
            + n_and * sys.buddy_op_ns("and", m_users)
    else:
        t_ops = n_or * sys.cpu_bitwise_ns("or", m_users) \
            + n_and * sys.cpu_bitwise_ns("and", m_users)
    # bitcount stays on the CPU in both systems (§8.1)
    t_cnt = n_cnt * sys.cpu_bitcount_ns(m_users)
    return t_ops + t_cnt


def speedup(m_users: int, n_weeks: int,
            sys: AppSystem = DEFAULT_APP_SYSTEM) -> float:
    return query_time_ns(m_users, n_weeks, False, sys) / \
        query_time_ns(m_users, n_weeks, True, sys)
