"""Solvers of the port (counterpart of ``repro.core``): the paper's DCF-PCA
and the baselines it is compared with (CF-PCA, APGM, IALM), all on the
solver runtime (``repro_torch.core.runtime``) and registered with the
``repro_torch.rpca`` front door (re-exported here as ``rpca`` /
``RPCASpec`` / ``RPCAResult`` / ``solve``), with the batched solvers
(``*_batch``, ``solve_batch``), ``driver`` and the shape-bucketed compile
cache (``CompilePolicy``, ``CompileCache``, ``CacheStats``,
``bucket_shape``, ``default_cache``) and the sharded engine
(``dcf_pca_sharded``: one client a ``torch.distributed`` rank)."""
from repro_torch import rpca
from repro_torch.core.apgm import APGMConfig, ConvexResult, apgm, apgm_batch
from repro_torch.core.cf_pca import CFResult, cf_pca, cf_pca_batch
from repro_torch.core.compile_cache import (
    CacheStats,
    CompileCache,
    CompilePolicy,
    bucket_shape,
    default_cache,
)
from repro_torch.core.dcf_pca import (
    DCFResult,
    dcf_pca,
    dcf_pca_batch,
    dcf_pca_sharded,
)
from repro_torch.core.factorized import DCFConfig
from repro_torch.core.ialm import IALMConfig, ialm, ialm_batch
from repro_torch.core.metrics import (
    CompletionErrors,
    completion_errors,
    low_rank_relative_error,
    rank_gap,
    relative_error,
    singular_value_error,
)
from repro_torch.core.problems import (
    RPCAProblem,
    client_column_counts,
    generate_mask,
    generate_problem,
    merge_columns,
    pack_mask,
    participation_schedule,
    split_columns,
    unpack_mask,
)
from repro_torch.core.validate import CapacityError, QueueFull
from repro_torch.core.runtime import (
    CHUNKED,
    EARLY,
    FIXED,
    RUN_PRESETS,
    RunConfig,
    SolveStats,
    Solver,
    driver,
    resolve_run,
    solve_batch,
)
from repro_torch.rpca import RPCAResult, RPCASpec, solve

__all__ = [
    "rpca",
    "RPCAResult",
    "RPCASpec",
    "solve",
    "CHUNKED",
    "EARLY",
    "FIXED",
    "RUN_PRESETS",
    "resolve_run",
    "APGMConfig",
    "ConvexResult",
    "apgm",
    "apgm_batch",
    "CFResult",
    "cf_pca",
    "cf_pca_batch",
    "CacheStats",
    "CompileCache",
    "CompilePolicy",
    "bucket_shape",
    "default_cache",
    "DCFConfig",
    "DCFResult",
    "dcf_pca",
    "dcf_pca_batch",
    "dcf_pca_sharded",
    "IALMConfig",
    "ialm",
    "ialm_batch",
    "RunConfig",
    "SolveStats",
    "Solver",
    "driver",
    "solve_batch",
    "CapacityError",
    "QueueFull",
    "CompletionErrors",
    "completion_errors",
    "low_rank_relative_error",
    "rank_gap",
    "relative_error",
    "singular_value_error",
    "RPCAProblem",
    "client_column_counts",
    "generate_mask",
    "generate_problem",
    "merge_columns",
    "pack_mask",
    "participation_schedule",
    "split_columns",
    "unpack_mask",
]
