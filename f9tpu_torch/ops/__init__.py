"""Device ops of the port (counterpart of `f9tpu.ops`).

Modules are imported by name (``from f9tpu_torch.ops import src_kernel``).
The package itself exports the analysis reductions and the test signals,
as the JAX package's does; importing it builds no kernel.
"""

from .analysis import (  # noqa: F401
    rms, rms_db, peak, peak_db, noise_floor_db, peak_position, first_above,
    remove_dc_offset,
)
from .signal import sine, impulse, log_sweep  # noqa: F401
