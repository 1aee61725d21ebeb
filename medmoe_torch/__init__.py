"""medmoe_torch — the PyTorch/CUDA port of medmoe_tpu for NVIDIA Hopper.

Mirrors medmoe_tpu's layout module by module. The JAX package stays the
reference: every ported part is tested against its JAX counterpart on the
same weights. Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
