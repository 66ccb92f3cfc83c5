"""Scan sharing across tenants: one proven superset scan per table.

The DQService keeps tenants apart but would scan one table once per
tenant. What makes sharing safe is static: the plan-subsumption prover
(lint/subsume.py) proves each participant's suite CONTAINED in the
union plan the group builds (ops/fused.build_union_plan), so ONE fused
scan folds every participant's states, and the fan-out is a selection
over the state semigroup: each tenant gets its solo run's bits.

Here (service/service.py orchestrates around it):

* ``dataset_fingerprint``: the grouping key. By content for partitioned
  sources (the hash of the partition fingerprints the state cache keys
  on), by object identity for an in-memory table submitted directly.
  ``None`` means equality of the data cannot be shown, and the
  submission scans solo.
* ``plan_share_group``: the prover's gate. It builds the union plan,
  proves each candidate contained (the environment read from the live
  runtime for the service's device, the same on both sides, so a fold
  variant or dtype can never merge by accident), and splits participants
  from declines with their reasons.
* ``FanoutStateRepository``: state persistence per tenant for the shared
  scan. Every committed partition saves the union's states under the
  shared dataset AND each tenant's analyzer subset under the tenant's
  own dataset with the tenant's own solo plan signature, signed for the
  service's device, so a later solo run on that device (or a group
  formed again after a preemption) resumes from cache. Loads assemble
  the union from the tenants' entries when the shared entry is missing.
* ``ForensicsFanout``: one ForensicsCapture per tenant behind the fused
  pass's one forensics hook; each tenant's reservoirs stay its own (and
  their seeds derive from content per constraint, so each tenant's
  samples equal its solo run's).

The JAX counterpart is deequ_tpu/service/sharing.py. The difference:
every plan environment and signature here is that of one device, the
service's, which on the card signs with the "cuda-folds" variant.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.ops import runtime

#: the dataset name prefix of the shared scan's state envelopes
SHARED_DATASET_PREFIX = "shared/"


# -- grouping key -------------------------------------------------------------


def dataset_fingerprint(data: Any, table: Any) -> Optional[str]:
    """The sharing group key of one submission, or None when the equality
    of the data behind it cannot be established statically.

    ``data`` is what the caller submitted (a Table or a factory), ``table``
    the opened Table. Partitioned sources key on content, the digest of
    their partition fingerprints, which survives reopening the same
    files. An in-memory table submitted directly keys on its identity
    (two tenants passing the SAME Table object verify the same data); an
    in-memory table a factory opened has no identity across opens and
    never shares."""
    parts_fn = getattr(table, "partitions", None)
    if parts_fn is not None:
        try:
            h = hashlib.sha256()
            n = 0
            for part in parts_fn():
                h.update(str(part.fingerprint).encode("utf-8") + b"\x00")
                n += 1
            if n:
                return "parts:" + h.hexdigest()[:32]
        except Exception:  # noqa: BLE001 — an unknowable identity never shares
            return None
    if not callable(data) and data is table:
        return f"obj:{id(table)}"
    return None


def shared_dataset_name(fingerprint: str) -> str:
    return SHARED_DATASET_PREFIX + fingerprint.replace("/", "_")[:44]


# -- the prover's gate ----------------------------------------------------------


def current_plan_env(table: Any, batch_size: Optional[int] = None, device: Any = None):
    """The live runtime's plan-signature components for `device` (resolved
    as the runners resolve it) as a `lint.subsume.PlanEnv`: the fields
    `repository.states.plan_signature_for` hashes for a run there."""
    from deequ_tpu_torch.lint.subsume import PlanEnv
    from deequ_tpu_torch.repository.states import dtype_name

    device = runtime.resolve_device(device)
    batch_rows = getattr(table, "batch_rows", None)
    return PlanEnv(
        placement=runtime.placement_mode(device),
        compute_dtype=dtype_name(runtime.compute_dtype()),
        batch_size=batch_size,
        batch_rows=int(batch_rows) if batch_rows else None,
        fold_variant=runtime.fold_signature_variant(device),
    )


def submission_plan(checks: Sequence[Any], analyzers: Sequence[Any]) -> List[Any]:
    """One submission's deduplicated analyzer plan, in the order the
    verification suite collects it (required analyzers first, then each
    check's)."""
    from deequ_tpu_torch.lint.explain import _plan_analyzers

    return _plan_analyzers(analyzers, checks)


def _solo_order(checks: Sequence[Any], analyzers: Sequence[Any]) -> List[Any]:
    """One submission's analyzers in the order its SOLO run folds them:
    the required analyzers, then each check's `required_analyzers()` in
    that set's iteration order, deduplicated, as
    `VerificationSuite._do_verification_run` collects them. A solo run
    signs its cache entries over this order; `submission_plan`'s
    constraint order differs from it whenever the set's order (which
    follows the string hashes of the process) does, and a fan-out signed
    over that order would warm nothing."""
    plan: List[Any] = list(analyzers)
    for check in checks:
        plan.extend(check.required_analyzers())
    return list(dict.fromkeys(plan))


def plan_share_group(
    plans: Sequence[List[Any]],
    table: Any,
    device: Any = None,
) -> Tuple[List[Any], List[Any], List[Optional[str]]]:
    """Prove a group of submission plans shareable over ``table`` on
    ``device``.

    Returns ``(union, proofs, declines)``: the superset analyzer list,
    one `SubsumptionProof` per plan, and each plan's decline reason (None:
    proven CONTAINED, safe to share). A plan declines when its proof is
    anything but an exact CONTAINED: the union dedupes by engine
    identity, so respelled wheres stay separate members and every
    participant should prove exact; a residual or a mismatch here is a
    real incompatibility."""
    from deequ_tpu_torch.lint.schema import SchemaInfo
    from deequ_tpu_torch.lint.subsume import CONTAINED, prove_subsumption
    from deequ_tpu_torch.ops.fused import build_union_plan

    union, _memberships = build_union_plan(plans)
    try:
        schema = SchemaInfo.from_table(table)
    except Exception:  # noqa: BLE001 — the prover degrades to structural
        schema = None
    env = current_plan_env(table, device=device)
    proofs: List[Any] = []
    declines: List[Optional[str]] = []
    for plan in plans:
        proof = prove_subsumption(plan, union, schema, suite_env=env, scan_env=env)
        proofs.append(proof)
        declines.append(None if proof.verdict == CONTAINED else proof.summary())
    return union, proofs, declines


# -- state fan-out per tenant ---------------------------------------------------


class TenantStatePlan:
    """One tenant's part of the shared scan's state persistence: the
    dataset its envelopes key under, the scan-shareable analyzers a SOLO
    run of this tenant would fold, and that solo run's plan signature on
    `device`. `analyzers` must come in the solo run's order
    (`_solo_order`): the signature hashes it."""

    def __init__(self, dataset: str, analyzers: Sequence[Any], table: Any, device: Any = None) -> None:
        from deequ_tpu_torch.repository.states import plan_signature_for

        self.dataset = dataset
        self.analyzers = scan_shareable_subset(analyzers, table)
        self.signature = plan_signature_for(self.analyzers, table, device=device)


def scan_shareable_subset(analyzers: Sequence[Any], table: Any) -> List[Any]:
    """The analyzers of ``analyzers`` a solo run's FusedScanPass would
    fold, filtered as the runner filters them (deduped, preconditions
    met, no grouping analyzer, scan-shareable only), so the signature
    computed over them is the solo run's."""
    from deequ_tpu_torch.analyzers.base import Preconditions, ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer

    seen: set = set()
    subset: List[Any] = []
    for a in analyzers:
        if a in seen:
            continue
        seen.add(a)
        if not isinstance(a, ScanShareableAnalyzer) or isinstance(a, GroupingAnalyzer):
            continue
        try:
            if Preconditions.find_first_failing(table, a.preconditions()):
                continue
        except Exception:  # noqa: BLE001 — a failing precondition folds nothing
            continue
        subset.append(a)
    return subset


class FanoutStateRepository:
    """A StateRepository front for one shared scan.

    The fused pass uses it as any repository, keyed by the SHARED dataset
    and the union plan's signature. A save also writes each tenant's
    analyzers under the tenant's own (dataset, solo signature), so the
    shared scan warms every participant's solo cache; a load falls back
    to assembling the union from the tenants' entries, so a group formed
    again (other participants after a preemption) still resumes every
    partition an earlier attempt committed."""

    def __init__(self, inner: Any, tenants: Sequence[TenantStatePlan]) -> None:
        self.inner = inner
        self.tenants = list(tenants)

    def has_states(self, dataset: str, fingerprint: str, signature: str) -> bool:
        if self.inner.has_states(dataset, fingerprint, signature):
            return True
        return bool(self.tenants) and all(
            self.inner.has_states(t.dataset, fingerprint, t.signature) for t in self.tenants
        )

    def load_states(
        self,
        dataset: str,
        fingerprint: str,
        signature: str,
        analyzers: Sequence[Any],
    ) -> Optional[List[Any]]:
        states = self.inner.load_states(dataset, fingerprint, signature, analyzers)
        if states is not None:
            return states
        # the union from the tenants' solo entries
        by_analyzer: Dict[Any, Any] = {}
        for t in self.tenants:
            if not t.analyzers:
                continue
            loaded = self.inner.load_states(t.dataset, fingerprint, t.signature, t.analyzers)
            if loaded is None:
                continue
            for a, s in zip(t.analyzers, loaded):
                by_analyzer.setdefault(a, s)
        if not by_analyzer or any(a not in by_analyzer for a in analyzers):
            return None
        return [by_analyzer[a] for a in analyzers]

    def save_states(
        self,
        dataset: str,
        fingerprint: str,
        signature: str,
        pairs: Sequence[Tuple[Any, Any]],
    ) -> bool:
        saved = self.inner.save_states(dataset, fingerprint, signature, pairs)
        states = dict(pairs)
        for t in self.tenants:
            if not t.analyzers or any(a not in states for a in t.analyzers):
                continue  # never a partial tenant envelope
            self.inner.save_states(
                t.dataset, fingerprint, t.signature, [(a, states[a]) for a in t.analyzers]
            )
        return saved

    def disk_usage(self, dataset: str) -> Optional[int]:
        return self.inner.disk_usage(dataset)


# -- forensics fan-out per tenant -----------------------------------------------


class ForensicsFanout:
    """One ForensicsCapture per participant behind the one forensics hook
    the fused pass drives. Every hook the pass calls fans out; each
    tenant's reservoirs and coordinates stay its own, and since the
    reservoir seeds derive from content per constraint
    (observe/forensics._batch_seed), each tenant's samples equal its solo
    run's."""

    def __init__(self, captures: Sequence[Any]) -> None:
        self.captures = list(captures)

    def note_plan_signature(self, signature: str) -> None:
        for c in self.captures:
            c.note_plan_signature(signature)

    def note_partition(self, name: str, fingerprint: str, mode: str) -> None:
        for c in self.captures:
            c.note_partition(name, fingerprint, mode)

    def enter_partition(self, name: str, fingerprint: str) -> "ForensicsFanout":
        for c in self.captures:
            c.enter_partition(name, fingerprint)
        return self

    def note_table(self, source: Any) -> None:
        for c in self.captures:
            c.note_table(source)

    def note_decode_plan(self, plan: Any) -> None:
        for c in self.captures:
            c.note_decode_plan(plan)

    def capture_batch(self, batch: Any, row_offset: int) -> None:
        for c in self.captures:
            c.capture_batch(batch, row_offset)


# -- pro-rata quota split -------------------------------------------------------


def prorata_weights(predicted: Sequence[float]) -> Tuple[float, List[float]]:
    """Split one shared scan's bytes among its participants.

    ``predicted`` is each participant's own predicted solo scan bytes (its
    EXPLAIN cost). The shared scan reads the union's columns once, taken
    as the WIDEST participant's prediction, and each participant pays a
    share of that one read in proportion to its own demand. Returns
    ``(union_bytes, shares)`` with ``sum(shares) == union_bytes``:
    together the tenants pay for one scan, not K."""
    n = len(predicted)
    if n == 0:
        return 0.0, []
    union_bytes = max(float(p) for p in predicted)
    total = sum(float(p) for p in predicted)
    if union_bytes <= 0.0 or total <= 0.0:
        return 0.0, [0.0] * n
    return union_bytes, [union_bytes * float(p) / total for p in predicted]


__all__ = [
    "FanoutStateRepository",
    "ForensicsFanout",
    "SHARED_DATASET_PREFIX",
    "TenantStatePlan",
    "current_plan_env",
    "dataset_fingerprint",
    "plan_share_group",
    "prorata_weights",
    "scan_shareable_subset",
    "shared_dataset_name",
    "submission_plan",
]
