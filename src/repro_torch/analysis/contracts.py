"""Performance-contract declarations for the port's engine entry points.

A :class:`Contract` is the machine-readable form of the claims the engine
makes in prose: "the k rounds make no host sync", "ONE collective of O(m)
bytes per scored batch", "the fused kernel ping-pongs two cache buffers",
"half-precision payloads never widen to fp32". The :func:`contract`
decorator registers one against an entry point (or a factory that builds
one); the audit registry (:mod:`repro_torch.analysis.registry`) turns each
into concrete cases and :mod:`repro_torch.analysis.census` proves the
invariants against a run of the real code.

Where the reference compiles the k rounds into one program and audits the
program, a torch loop runs eagerly, so the vocabulary is what an eager loop
can break: host syncs per round, kernel launches per round, collectives
per round, buffers reused in place, and a round census that does not grow
with k.

This module is imported by ``repro_torch.core.*`` at definition time, so
it stays dependency-free: no torch, no numpy, no core imports.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple, Union

#: Global contract registry, keyed by contract name. Populated at import
#: time by the ``@contract`` decorators on the core entry points.
CONTRACTS: Dict[str, "Contract"] = {}

#: The host syncs a round may make, by name. Each entry is a line marked
#: marked with the lint's host-sync allow comment; the census attributes every
#: sync to its line and refuses one from any other line.
ALLOWED_SYNCS: Dict[str, str] = {
    "celf": "CELF's stopping-rule test: one scalar read per inner "
            "iteration of the lazy round's re-score loop",
}


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declared structural invariants of one entry point.

    The fields pin the shape of the claim; the exact per-case numbers (a
    graph-cut round carries one more owner gather, a sharded-pool round one
    owner gather per candidate block, ...) are derived by the audit
    registry from the case's (plan, strategy, function, backend).
    """

    name: str
    #: the registered callable: the entry point itself, or, when
    #: ``factory``, a builder returning it (the mesh plans and the offer
    #: loops are closures built per mesh and spec).
    fn: Callable = dataclasses.field(compare=False, repr=False)
    factory: bool = False
    #: host syncs one round may make: 0, or the name of an
    #: :data:`ALLOWED_SYNCS` entry.
    host_syncs_per_round: Union[int, str] = 0
    #: the kernels a round may launch, each with its most launches per
    #: scored batch: one dense or stochastic round, one CELF re-score, or
    #: one candidate block of the sharded pool.
    launches_per_round: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    #: c10d op names allowed in the run (``allgather_``, ``allreduce_``).
    #: Empty = the entry point must issue no collective.
    collective_kinds: Tuple[str, ...] = ()
    #: the buffers the rounds must reuse (written in place or ping-ponged)
    #: instead of allocating one per round.
    reuse: Tuple[str, ...] = ()
    #: every round issues the same op census (CELF's rounds run a
    #: data-dependent number of re-scores and are exempt).
    rounds_uniform: bool = True
    #: apply the precision-flow rule: no half payload of tile size widens
    #: to fp32 outside a kernel.
    precision: bool = True
    #: check the peak device memory against the analytic working-set bound
    #: of the case's route (on the card only).
    memory: bool = False
    #: short human description for the README table / report.
    claim: str = ""
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def contract(
    name: str,
    *,
    factory: bool = False,
    host_syncs_per_round: Union[int, str] = 0,
    launches_per_round: Mapping[str, int] = (),
    collective_kinds: Tuple[str, ...] = (),
    reuse: Tuple[str, ...] = (),
    rounds_uniform: bool = True,
    precision: bool = True,
    memory: bool = False,
    claim: str = "",
    **extra: Any,
) -> Callable:
    """Register a performance contract against the decorated entry point
    (returned untouched)."""
    if host_syncs_per_round not in (0, *ALLOWED_SYNCS):
        raise ValueError(f"host_syncs_per_round must be 0 or one of "
                         f"{sorted(ALLOWED_SYNCS)}, got "
                         f"{host_syncs_per_round!r}")

    def register(fn: Callable) -> Callable:
        if name in CONTRACTS:
            raise ValueError(f"duplicate contract {name!r}")
        CONTRACTS[name] = Contract(
            name=name, fn=fn, factory=factory,
            host_syncs_per_round=host_syncs_per_round,
            launches_per_round=dict(launches_per_round),
            collective_kinds=tuple(collective_kinds), reuse=tuple(reuse),
            rounds_uniform=rounds_uniform, precision=precision,
            memory=memory, claim=claim, extra=extra)
        return fn

    return register
