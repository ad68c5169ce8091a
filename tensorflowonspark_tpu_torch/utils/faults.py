"""Deterministic fault injection, driven by ``TFOS_FAULT_PLAN``.

An own copy of the part of ``tensorflowonspark_tpu/utils/faults.py``
that the decode engine and ``TrainMetrics`` call (``check``,
``poison``), with the same plan grammar, per-process hit counters and
executor scoping::

    plan  := entry ("," entry)*
    entry := site ":" kind ["(" arg ")"] ["@" hits]
    kind  := "exc" | "kill" | "hang" | "delay" | "nan"
    hits  := N | N "+" | "*"

``TFOS_FAULT_EXECUTOR`` scopes a plan to one executor (and the
processes it forks); ``TFOS_FAULT_INCARNATION`` further to one of its
incarnations (0 the first, each respawn one more), so that a kill does
not fire again in the respawn, whose hit counts start from 0.

``random_plan`` draws a seeded ``exc`` plan over a set of sites whose
faults the runtime recovers from (:data:`SERVE_CHAOS_SITES`,
:data:`DEPLOY_CHAOS_SITES`); the same seed gives the JAX package's plan.

``check`` and ``poison`` are free when no plan is set.  Every fault that
fires emits a ``fault/injected`` telemetry event.  ``nan`` entries are
value poison: ``poison`` fires them, ``check`` ignores them, as the
reference does.
"""

from __future__ import annotations

import logging
import os
import random as _random
import signal
import time

from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

PLAN_ENV = "TFOS_FAULT_PLAN"
EXECUTOR_ENV = "TFOS_FAULT_EXECUTOR"
INCARNATION_ENV = "TFOS_FAULT_INCARNATION"

KINDS = ("exc", "kill", "hang", "delay", "nan")

#: Injection points wired into the runtime (site -> where it fires).
SITES = (
    "engine.task",          # engine.py executor loop, before running a task
    "node.boot",            # node.py _mapfn, before the manager starts
    "node.main",            # node.py wrapper_fn, before user main_fun
    "train.step",           # utils/metrics.py TrainMetrics.step, per step
    "feed.put",             # node.py feeder, before each chunk put
    "feed.get",             # feed.py DataFeed, after each chunk pop
    "data.serve",           # data/service.py worker, before each unit
    "data.split_claim",     # data/service.py dynamic worker, after a claim
    "data.split_serve",     # data/service.py dynamic worker, per chunk
    "rendezvous.register",  # rendezvous.py Client.register
    "rendezvous.query",     # rendezvous.py Client.await_reservations polls
    "checkpoint.save",      # utils/checkpoint.py save paths
    "actor.spawn",          # actors/runtime.py member boot, before on_start
    "actor.receive",        # actors/runtime.py, before handling an envelope
    "actor.tick",           # actors/runtime.py idle tick, before on_tick
    "serve.dispatch",       # serving/replicas.py, before routing a request
    "serve.resize",         # serving/elastic.py, before a pool resize
    "serve.fabric_dispatch",  # serving/fabric/router.py, before a dispatch
    "serve.fabric_route",   # serving/fabric/router.py, affinity route pick
    "decode.step",          # serving/decode/scheduler.py engine loop body
    "deploy.canary",        # workloads/deploy_loop.py, before opening canary
    "deploy.promote",       # workloads/deploy_loop.py, before promote commit
    "deploy.rollback",      # workloads/deploy_loop.py, before rollback commit
)

#: Sites whose hit counters live in long-lived executor processes, so a
#: consumed occurrence stays consumed across engine retries.
CHAOS_SITES = ("engine.task", "node.boot", "feed.put", "rendezvous.query")

#: The serving tier's: a dispatch fault fails its batch (an explicit
#: client error), a resize fault is retried by the pool's next pass, a
#: decode fault fails the cohort and rebuilds the caches.
SERVE_CHAOS_SITES = ("serve.dispatch", "serve.resize", "decode.step")

#: The deploy loop's: each raises before its pool transition, and the
#: next pump retries it.
DEPLOY_CHAOS_SITES = ("deploy.canary", "deploy.promote", "deploy.rollback")


class FaultInjected(RuntimeError):
    """An exception raised by an injected ``exc`` fault."""


class _Fault:
    __slots__ = ("site", "kind", "arg", "first", "last")

    def __init__(self, site, kind, arg, first, last):
        self.site = site
        self.kind = kind
        self.arg = arg
        self.first = first  # 1-based hit the fault starts firing on
        self.last = last    # last firing hit (None = open-ended)

    def matches(self, hit):
        if hit < self.first:
            return False
        return self.last is None or hit <= self.last

    def __repr__(self):
        hits = ("*" if (self.first, self.last) == (1, None)
                else f"{self.first}+" if self.last is None
                else str(self.first))
        arg = f"({self.arg:g})" if self.arg is not None else ""
        return f"{self.site}:{self.kind}{arg}@{hits}"


def parse_plan(plan):
    """``TFOS_FAULT_PLAN`` string -> list of :class:`_Fault`.

    Raises ``ValueError`` on malformed entries — a typo'd plan must fail
    loudly, not silently inject nothing.
    """
    faults = []
    for raw in str(plan or "").split(","):
        entry = raw.strip()
        if not entry:
            continue
        site, sep, rest = entry.partition(":")
        site = site.strip()
        if not sep or not site:
            raise ValueError(f"fault entry {entry!r}: expected site:kind")
        if site not in SITES:
            raise ValueError(
                f"fault entry {entry!r}: unknown site {site!r} "
                f"(valid: {', '.join(SITES)})")
        rest, _, hits_s = rest.partition("@")
        kind, arg = rest.strip(), None
        if "(" in kind:
            if not kind.endswith(")"):
                raise ValueError(f"fault entry {entry!r}: unclosed arg")
            kind, arg_s = kind[:-1].split("(", 1)
            try:
                arg = float(arg_s)
            except ValueError:
                raise ValueError(
                    f"fault entry {entry!r}: non-numeric arg {arg_s!r}"
                ) from None
        if kind not in KINDS:
            raise ValueError(
                f"fault entry {entry!r}: unknown kind {kind!r} "
                f"(valid: {', '.join(KINDS)})")
        hits_s = hits_s.strip() or "1"
        if hits_s == "*":
            first, last = 1, None
        elif hits_s.endswith("+"):
            first, last = int(hits_s[:-1]), None
        else:
            first = int(hits_s)
            last = first
        if first < 1:
            raise ValueError(f"fault entry {entry!r}: hits are 1-based")
        faults.append(_Fault(site, kind, arg, first, last))
    return faults


# Per-process parse cache + hit counters.  Keyed by pid: a fork child
# inherits the parent's dict but must count its own hits from zero.
_state = {"pid": None, "plan": None, "faults": (), "hits": {}}


def _faults_for_this_process():
    plan = os.environ.get(PLAN_ENV, "")
    if _state["pid"] != os.getpid() or _state["plan"] != plan:
        _state["pid"] = os.getpid()
        _state["plan"] = plan
        _state["hits"] = {}
        try:
            _state["faults"] = tuple(parse_plan(plan))
        except ValueError:
            logger.exception("invalid %s=%r; injecting nothing", PLAN_ENV, plan)
            _state["faults"] = ()
    return _state["faults"]


def _scoped_out():
    """True when TFOS_FAULT_EXECUTOR is set and this process (or its
    executor ancestor) is a different executor, or TFOS_FAULT_INCARNATION
    is set and this is another incarnation of it."""
    want = os.environ.get(EXECUTOR_ENV, "").strip()
    if want and os.environ.get("TFOS_EXECUTOR_INDEX", "").strip() != want:
        return True
    life = os.environ.get(INCARNATION_ENV, "").strip()
    return bool(life) and \
        os.environ.get("TFOS_EXECUTOR_INCARNATION", "").strip() != life


def check(site, **attrs):
    """Injection point: count a hit on ``site`` and fire any planned fault.

    Free when no plan is set (one env read + dict lookup).  Call it at
    the top of the operation it guards; ``attrs`` travel into the
    ``fault/injected`` telemetry event for the recovery timeline.
    """
    faults = _faults_for_this_process()
    if not faults:
        return
    # nan entries are value poison (the reference's poison()); a check at
    # the same site must neither fire nor count them
    armed = [f for f in faults if f.site == site and f.kind != "nan"]
    if not armed or _scoped_out():
        return
    hit = _state["hits"].get(site, 0) + 1
    _state["hits"][site] = hit
    for f in armed:
        if not f.matches(hit):
            continue
        logger.warning("fault injection: %r firing at hit %d of %s (pid %d)",
                       f, hit, site, os.getpid())
        telemetry.event("fault/injected", site=site, kind=f.kind, hit=hit,
                        pid=os.getpid(), **attrs)
        # a kill/hang never returns: the event must already be on disk
        telemetry.flush()
        if f.kind == "exc":
            raise FaultInjected(
                f"injected fault at {site} (hit {hit}, plan {f!r})")
        if f.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)  # pending-signal window; never reached
        if f.kind == "hang":
            time.sleep(3600.0 if f.arg is None else f.arg)
            raise FaultInjected(
                f"injected hang at {site} expired (hit {hit}, plan {f!r})")
        if f.kind == "delay":
            time.sleep(1.0 if f.arg is None else f.arg)
        return


def poison(site, value):
    """Value-poison injection point: return ``value``, or ``float('nan')``
    when a planned ``nan`` fault fires on this hit.  Hits are counted per
    process per site under a separate ``nan`` counter."""
    faults = _faults_for_this_process()
    if not faults:
        return value
    armed = [f for f in faults if f.site == site and f.kind == "nan"]
    if not armed or _scoped_out():
        return value
    key = site + "#nan"
    hit = _state["hits"].get(key, 0) + 1
    _state["hits"][key] = hit
    for f in armed:
        if not f.matches(hit):
            continue
        logger.warning("fault injection: %r poisoning hit %d of %s (pid %d)",
                       f, hit, site, os.getpid())
        telemetry.event("fault/injected", site=site, kind="nan", hit=hit,
                        pid=os.getpid())
        return float("nan")
    return value


def random_plan(seed, max_faults=2, sites=CHAOS_SITES):
    """A reproducible chaos plan of ``exc`` faults over ``sites``: the
    same seed gives the same plan (the JAX package's), always
    parseable."""
    rng = _random.Random(int(seed))
    entries = []
    for _ in range(rng.randint(1, max_faults)):
        site = rng.choice(list(sites))
        entries.append(f"{site}:exc@{rng.randint(1, 3)}")
    plan = ",".join(entries)
    parse_plan(plan)  # a generator bug fails here, not mid-run
    return plan


def _reset_for_tests():
    """Forget the cached plan and the hit counters (tests only)."""
    _state.update(pid=None, plan=None, faults=(), hits={})
