"""babe_tpu_torch — the PyTorch + CUDA (Hopper) port of the JAX package
``babe_tpu``.

Zero-shot blind audio bandwidth extension (BABE) on the CQTDiff+ diffusion
prior, written in PyTorch.  The module layout and public names mirror the
JAX package ``babe_tpu`` so each piece has an obvious counterpart; the port
imports nothing from it.  Activations keep the JAX layout (B, F, T, C) at
public functions.

The two hot kernels of the sampling path are hand-written CUDA for sm_90a
(``csrc/``), built at first use and bound with ctypes (``kernels/``):

  * ``ops.conv_kernels.conv5x3_dilated``  'SAME' (5,3) conv, dilation (d,1)
  * ``ops.conv_kernels.fused_stage``      one ResnetBlock dilation stage

Library entry point: ``babe_tpu_torch.api.BABE``.
"""

__version__ = "0.1.0"
