"""Filter design and the float64 oracle: the port's copy of `f9tpu/models/`
(numpy only), so the port imports nothing of the JAX package."""

from .filters import CycleBank, design_cycle_bank, resolve_ratio, QUALITY_PRESETS  # noqa: F401
from .oracle import resample_oracle  # noqa: F401
