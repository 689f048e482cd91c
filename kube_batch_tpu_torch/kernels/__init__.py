"""Hand-written Hopper kernels of the main path, one wrapper each.

| kernel | wrapper | route | replaces (kube_batch_tpu/) |
| --- | --- | --- | --- |
| K1 | predicate_mask.predicate_mask (word packing, then set tests on the words) | CUDA C++ | plugins/predicates.py · register.predicate |
| K2 | propose.propose_best, propose.propose_pick | CUDA C++ | ops/assignment.py · allocate_rounds (propose half), _round_robin_proposals |
| K3 | resolve.resolve (sort, prefix fit, serialize count, watermark: one launch), resolve.apply | CUDA C++ | ops/assignment.py · _resolve_conflicts, _segment_prefix, apply step |
| K4 | failure_counts.failure_counts (the dynamic predicate as a mask or as K10's words, tested in its own launch) | CUDA C++ | framework/fit_errors.py · failure_counts |
| K5 | victim_prefix.victim_prefix (the opening step's node choice: sort, walk, mask, choice) | CUDA C++ | ops/preemption.py · _min_victims_per_node, choose_node |
| K6 | preempt_scan.preempt_open, preempt_scan.preempt_continue (a continuing step's whole classification) | CUDA C++ | ops/preemption.py · preemption_rounds (the step's scans and a continuing step's classification) |
| K7 | segment_sum.segment_sum, segment_sum.segment_count, segment_sum.waterfill (a warp a column to its fixed point; given RequestRows, the queue-request sum in the same launch) | CUDA C++ | api/snapshot.py · count_per_job / sum_req_per_job and the plugins' segment sums; ops/waterfill.py · waterfill_deserved with proportion's queue_request |
| K8 | lex_rank.lex_push_many, lex_rank.sort_by_segment, lex_rank.vtime | CUDA C++ | framework/policy.py · rank_fn, virtual_start_times; ops/assignment.py · rank_from_keys |
| K9 | row_patch.row_patch (dirty rows gathered from the host arrays into a pinned ring slot; one launch, every field's copy units in one grid) | CUDA C++ | cache/incremental.py · _row_patch |
| K10 | affinity.affinity_words (tested in K2's and K4's launches), affinity.affinity_task_words, affinity.affinity_mask, affinity.affinity_row | CUDA C++ | plugins/predicates.py · _topo_feasibility, _affinity_candidate_ok, pod_affinity_predicate, pod_affinity_row |
| K11 | resident.resident_words | CUDA C++ | plugins/predicates.py · resident_podlabels, _resident_mask, resident_domain_labels, bootstrap_mask's Hb.any(0) |
| K12 | joint_tier.tier_control | CUDA C++ | ops/joint.py · _haswork_fn, advance (the tier_done test), the step's read |
| K13 | podaff_score.podaff_score (a table of one row per class of preference rows from K11's words, read by K2 at each task's class) | CUDA C++ | plugins/nodeorder.py · pod_affinity_score |

Every wrapper runs its plain PyTorch version for CPU tensors, launches
its kernel for CUDA tensors (or raises), and counts its launches in a
plain int attribute `launches`.
"""

from kube_batch_tpu_torch.kernels import (  # noqa: F401
    affinity,
    failure_counts,
    joint_tier,
    lex_rank,
    podaff_score,
    predicate_mask,
    preempt_scan,
    propose,
    resident,
    resolve,
    row_patch,
    segment_sum,
    victim_prefix,
)


def wrappers() -> dict:
    """name → wrapper function (each carries a `launches` counter)."""
    return {
        "predicate_mask": predicate_mask.predicate_mask,
        "propose_best": propose.propose_best,
        "propose_pick": propose.propose_pick,
        "resolve": resolve.resolve,
        "apply": resolve.apply,
        "failure_counts": failure_counts.failure_counts,
        "victim_prefix": victim_prefix.victim_prefix,
        "preempt_open": preempt_scan.preempt_open,
        "preempt_continue": preempt_scan.preempt_continue,
        "segment_sum": segment_sum.segment_sum,
        "segment_count": segment_sum.segment_count,
        "waterfill": segment_sum.waterfill,
        "lex_push_many": lex_rank.lex_push_many,
        "sort_by_segment": lex_rank.sort_by_segment,
        "vtime": lex_rank.vtime,
        "row_patch": row_patch.row_patch,
        "affinity_mask": affinity.affinity_mask,
        "affinity_row": affinity.affinity_row,
        "affinity_words": affinity.affinity_words,
        "affinity_task_words": affinity.affinity_task_words,
        "resident_words": resident.resident_words,
        "tier_control": joint_tier.tier_control,
        "podaff_score": podaff_score.podaff_score,
    }


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}
