"""Device ops of the port (counterpart of `f9tpu.ops`).

Modules are imported by name (``from f9tpu_torch.ops import src_kernel``);
this package imports nothing itself, so importing it builds no kernel.
"""
