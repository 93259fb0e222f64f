"""Checkpointing and the serving artifact on disk (``checkpoint``).

The JAX package's ``fp8tpu.utils`` also holds stats telemetry
(``stats``), ``bindump``, ``metrics`` and ``profiling``: not ported yet
(ROADMAP §1 item 8)."""

from .checkpoint import (  # noqa: F401
    load_serve_artifact,
    policy_from_json,
    policy_to_json,
    restore_checkpoint,
    save_checkpoint,
    save_serve_artifact,
)
