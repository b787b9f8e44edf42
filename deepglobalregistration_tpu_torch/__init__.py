"""deepglobalregistration_tpu_torch — Deep Global Registration in PyTorch for NVIDIA Hopper.

A port of the JAX package ``deepglobalregistration_tpu`` (kept beside it as
the reference). Module names mirror the JAX package so each counterpart is
easy to find: ``ops/`` (geometry, grids, kernel maps, sparse convolution,
1-NN), ``models/`` (ResUNet family), ``core/`` (refinement loop and the
``DeepGlobalRegistration`` pipeline), ``utils/`` (device policy, checkpoint
loading, weight conversion), ``tools/`` (the gather probe).

The feature 1-NN and the ICP 1-NN run through a hand-written CUDA kernel
(``csrc/nn1.cu``), and the gather probe through two more (``csrc/gather.cu``),
built with ``nvcc`` for ``sm_90a`` at first use.
"""

__version__ = "0.1.0"
