"""Runtime contract audit of the port's engine and a lint of its source.

Two layers:

* **Contract audit** (:mod:`repro_torch.analysis.census`,
  :mod:`repro_torch.analysis.registry`) — every engine entry point carries
  a :func:`repro_torch.analysis.contracts.contract` declaring its
  structural invariants: host syncs per round, kernel launches per round,
  collectives per round and their largest operand, buffers reused in
  place, a round census that does not grow with k, and the precision
  flow. The auditor runs each entry point over the documented case grid
  under a ``TorchDispatchMode`` that records every op, at k = K, K+1 and
  K+2: the differences are one round's census, and the two must agree.
* **Source lint** (:mod:`repro_torch.analysis.lint`) — an AST pass over
  ``src/repro_torch`` catching host syncs inside the loop bodies, float
  equality and numpy on a loop body's tensors.

CLI: ``python -m repro_torch.analysis.audit [--json OUT] [--lint-only]
[--audit-only] [--quick] [--filter SUBSTR] [--device cuda|cpu]`` — exits
non-zero on any violation. ``tests/test_torch_analysis.py`` proves each
checker detects the defect class it exists for.
"""
from repro_torch.analysis.contracts import CONTRACTS, Contract, contract

__all__ = ["CONTRACTS", "Contract", "contract"]
