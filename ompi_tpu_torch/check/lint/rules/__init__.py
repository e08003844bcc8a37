"""Lint rules — the MPI-aware static checks, split by family over
the staged analysis engine (the one ``rules.py`` pass the JAX package
started with grew CFG/dataflow/callgraph machinery and now lives in
four modules; this is the port's copy of ``ompi_tpu/check/lint/rules``):

- :mod:`requests` — request/handle lifecycle, path-aware over the
  CFG (``unwaited-request``, ``buffer-reuse-before-wait``,
  ``handle-leak``) plus the lexical ``pready-outside-start``;
- :mod:`collective` — the ``collective-order-divergence`` static
  deadlock detector (superseding the lexical
  ``rank-divergent-collective``);
- :mod:`conventions` — repo-convention checks
  (``bare-public-raise``, ``unregistered-pvar``,
  ``unguarded-observability``).

Each rule is ``(ModuleContext) -> List[Finding]``; the runner
(:mod:`ompi_tpu_torch.check.lint`) builds the context (AST + parents +
project call graph), applies ``# check: disable=RULE`` suppressions,
emits ``stale-suppression`` for disable comments that no longer
suppress anything, and renders findings. Rules are deliberately
conservative: any use of a handle the analysis cannot prove dead
counts as handled, so a finding is close to a real defect, not a
style opinion (the MUST/Marmot bar, not the pylint bar).
"""

from __future__ import annotations

from typing import Dict

# compat re-exports: the model is the stable import surface the old
# monolithic rules.py exposed
from ompi_tpu_torch.check.lint.model import (  # noqa: F401
    COLLECTIVES, CONTAINER_ADDERS, FREE_NAMES, GUARD_GLOBALS,
    HANDLE_PRODUCER_FNS, HANDLE_PRODUCERS, NONBLOCKING_SENDS,
    PART_INIT, PREADY_NAMES, PUBLIC_API_DIRS, REQUEST_CONSUMERS,
    REQUEST_PRODUCERS, START_NAMES, Finding, ModuleContext,
    build_parents,
)
from ompi_tpu_torch.check.lint.rules.collective import \
    rule_collective_order_divergence
from ompi_tpu_torch.check.lint.rules.conventions import (
    rule_bare_public_raise, rule_unguarded_observability,
    rule_unregistered_pvar,
)
from ompi_tpu_torch.check.lint.rules.osc import rule_osc_unclosed_epoch
from ompi_tpu_torch.check.lint.rules.requests import (
    rule_buffer_reuse_before_wait, rule_handle_leak,
    rule_pready_outside_start, rule_unwaited_request,
)

#: rule id -> one-line description (the ``check rules`` catalog)
CATALOG: Dict[str, str] = {
    "unwaited-request":
        "a request-producing call (isend/irecv/*_init/I*, or a "
        "helper the call graph proves returns a request) that is "
        "dropped, or bound to a name some CFG path lets reach the "
        "scope exit without a Wait/Test/free — a request waited on "
        "only one branch is a finding; one appended to a list that "
        "is later consumed, or passed to a helper that waits it, is "
        "not",
    "pready-outside-start":
        "Pready on a partitioned request with no Start/start_all "
        "between the psend_init and the Pready — partitions marked "
        "ready outside an active partitioned region",
    "collective-order-divergence":
        "two CFG paths whose divergence is a rank-dependent branch "
        "(comm.rank/Get_rank, or a local tainted by one) run "
        "different collective sequences on that comm before "
        "re-converging — the static deadlock detector; a branch "
        "issuing the same sequence on both arms passes (supersedes "
        "the lexical rank-divergent-collective)",
    "buffer-reuse-before-wait":
        "a buffer handed to a nonblocking send is written again on "
        "some CFG path before the request is waited — the transfer "
        "may read the new bytes",
    "handle-leak":
        "a comm/window/file handle created in a function with a CFG "
        "path to the exit on which it is never freed, closed, "
        "returned, stored, or passed on",
    "bare-public-raise":
        "raise ValueError/TypeError on an MPI API path (coll/, osc/, "
        "shmem/, part/, ingest/, elastic/) — raise "
        "errors.MPIError(ERR_*) so "
        "the comm errhandler sees it (a bare ValueError bypasses "
        "_with_errhandler dispatch)",
    "unregistered-pvar":
        "pvar recorded under a literal name missing from "
        "pvar.WELL_KNOWN — tools/info and the OpenMetrics sampler "
        "will not export it at 0 (dynamic f-string families are "
        "exempt)",
    "osc-unclosed-epoch":
        "an RMA epoch opener (Lock/Lock_all/Start/Post) on a window "
        "created in the same scope with no matching closer "
        "(Unlock/Unlock_all/Complete/Wait) on that window later in "
        "the scope — the epoch never ends, so peers hang in the sync "
        "handshake and the window cannot Free",
    "unguarded-observability":
        "direct call through an observability guard global (FLIGHT/"
        "RECORDER/SANITIZER/TRAFFIC/INGEST) with no enclosing None "
        "check — hot paths must bind the guard once and branch on it",
    "stale-suppression":
        "a '# check: disable=RULE' comment that no longer suppresses "
        "any finding on its line — remove it, or it will hide the "
        "rule when the code regresses",
    "parse-error":
        "the file does not parse; nothing else can be checked "
        "(never suppressible or baselineable)",
}

RULES = (
    rule_unwaited_request,
    rule_pready_outside_start,
    rule_collective_order_divergence,
    rule_buffer_reuse_before_wait,
    rule_handle_leak,
    rule_osc_unclosed_epoch,
    rule_bare_public_raise,
    rule_unregistered_pvar,
    rule_unguarded_observability,
)
