"""Core submodular exemplar-clustering library (the paper's contribution)."""
from repro_torch.core.clustering import ExemplarModel, fit_exemplar_clustering
from repro_torch.core.engine import (OptResult, run_selection, run_selection_batch,
                                     stage_selection_batch, validate_candidates)
from repro_torch.core.evaluator import (
    ChunkingError,
    EvalConfig,
    bytes_per_set,
    evaluate_multiset,
    plan_chunks,
    work_matrix,
)
from repro_torch.core.functions import (FUNCTIONS, ExemplarClustering, FacilityLocation,
                                        FeatureBased, FnSpec, GraphCut, SaturatedCoverage,
                                        SubmodularFunction)
from repro_torch.core.multiset import PackedMultiset, pack_base_plus_candidates, pack_sets
from repro_torch.core.optimizers import (OPTIMIZERS, greedy, lazy_greedy, salsa, sieve_streaming,
                                         sieve_streaming_pp, stochastic_greedy, three_sieves)
from repro_torch.core.precision import BF16, FP16, FP16_STRICT, FP32, PrecisionPolicy
from repro_torch.core.service import (MultiStreamIngestionService, MultiStreamSnapshot,
                                      SelectionService, SieveSnapshot, StreamIngestionService)
from repro_torch.core.streaming import (BatchedSieveEngine, DeviceSieveEngine, HostSieveMirror,
                                        SieveSpec, SieveState, make_batched_sieve_engine,
                                        make_sieve_engine)

__all__ = [
    "BF16", "FP16", "FP16_STRICT", "FP32", "PrecisionPolicy",
    "ChunkingError", "EvalConfig", "bytes_per_set", "evaluate_multiset",
    "plan_chunks", "work_matrix", "run_selection", "run_selection_batch",
    "stage_selection_batch", "validate_candidates", "SelectionService",
    "FUNCTIONS", "ExemplarClustering", "FacilityLocation", "FeatureBased",
    "GraphCut", "SaturatedCoverage", "FnSpec", "SubmodularFunction",
    "PackedMultiset",
    "pack_base_plus_candidates", "pack_sets", "OPTIMIZERS", "OptResult",
    "greedy", "lazy_greedy", "stochastic_greedy", "ExemplarModel",
    "fit_exemplar_clustering", "salsa", "sieve_streaming",
    "sieve_streaming_pp", "three_sieves", "BatchedSieveEngine",
    "DeviceSieveEngine", "HostSieveMirror", "SieveSpec", "SieveState",
    "make_batched_sieve_engine", "make_sieve_engine",
    "MultiStreamIngestionService", "MultiStreamSnapshot", "SieveSnapshot",
    "StreamIngestionService",
]
