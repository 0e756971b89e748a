"""PyTorch/CUDA port of ``context_attentive_ir_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its module layout
and names.  It imports torch and numpy, never JAX or the JAX package.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
