"""Observability and state on disk: stats telemetry (``stats``),
``bindump``, checkpointing and the serving artifact (``checkpoint``),
``metrics`` and ``profiling``."""

from .bindump import (  # noqa: F401
    BindumpSchedule,
    TensorDumpHelper,
    bindump_tensor,
    bindump_tree,
)
from .checkpoint import (  # noqa: F401
    global_params,
    load_serve_artifact,
    local_params,
    policy_from_json,
    policy_to_json,
    restore_checkpoint,
    save_checkpoint,
    save_serve_artifact,
)
from .metrics import (  # noqa: F401
    MetricLogger,
    SmoothedValue,
    accuracy,
    all_reduce_mean,
)
from .profiling import Timer, annotate, benchmark, trace  # noqa: F401
from .stats import (  # noqa: F401
    log2_histogram,
    stats_window_enabled,
    tensor_stats,
    tree_stats,
)
