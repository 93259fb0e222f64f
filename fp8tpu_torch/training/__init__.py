"""FP8 mixed-precision training (``fp8tpu/training/mpt.py``)."""

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
