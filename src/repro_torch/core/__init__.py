"""Core submodular exemplar-clustering library (the paper's contribution)."""
from repro_torch.core.clustering import ExemplarModel, fit_exemplar_clustering
from repro_torch.core.engine import OptResult, run_selection, validate_candidates
from repro_torch.core.evaluator import (
    ChunkingError,
    EvalConfig,
    bytes_per_set,
    evaluate_multiset,
    plan_chunks,
    work_matrix,
)
from repro_torch.core.functions import ExemplarClustering, FnSpec, SubmodularFunction
from repro_torch.core.multiset import PackedMultiset, pack_base_plus_candidates, pack_sets
from repro_torch.core.optimizers import OPTIMIZERS, greedy, lazy_greedy, stochastic_greedy
from repro_torch.core.precision import BF16, FP16, FP16_STRICT, FP32, PrecisionPolicy

__all__ = [
    "BF16", "FP16", "FP16_STRICT", "FP32", "PrecisionPolicy",
    "ChunkingError", "EvalConfig", "bytes_per_set", "evaluate_multiset",
    "plan_chunks", "work_matrix", "run_selection", "validate_candidates",
    "ExemplarClustering", "FnSpec", "SubmodularFunction", "PackedMultiset",
    "pack_base_plus_candidates", "pack_sets", "OPTIMIZERS", "OptResult",
    "greedy", "lazy_greedy", "stochastic_greedy", "ExemplarModel",
    "fit_exemplar_clustering",
]
