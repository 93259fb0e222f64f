"""FP8 mixed-precision training (``fp8tpu/training/mpt.py``) and the 8-bit
optimizer (``fp8tpu/training/opt8.py``)."""

from .opt8 import (  # noqa: F401
    Adam8State,
    Adam8W,
    Moment8,
    adamw_8bit,
    scale_by_adam_8bit,
    state_bytes,
)

from .mpt import (  # noqa: F401
    EMB_CFGS,
    MASTER_CFGS,
    LossScaleState,
    MPTEmulator,
    init_train_state,
    initialize,
    make_train_step,
    master_requant,
    quantize_wtgrads,
    step_grads,
)
