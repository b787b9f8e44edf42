"""deepglobalregistration_tpu_torch — Deep Global Registration in PyTorch for NVIDIA Hopper.

A port of the JAX package ``deepglobalregistration_tpu`` (kept beside it as
the reference). Module names mirror the JAX package so each counterpart is
easy to find: ``ops/`` (geometry, grids, kernel maps, sparse convolution,
1-NN), ``models/`` (ResUNet family), ``core/`` (refinement loop and the
``DeepGlobalRegistration`` pipeline, with ``register_batch``'s batched
program), ``utils/`` (device policy, checkpoint loading, weight conversion),
``tools/`` (the gather probe, ``register_batch`` against ``register_many``).

The 1-NN searches run through two hand-written CUDA kernels, chosen by the
rows' width: the ICP's xyz scan through a register-tiled CUDA-core scan
(``csrc/nn1_scan.cu``, C <= 8) and the feature match through a 3xTF32
tensor-core kernel (``csrc/nn1_mma.cu``, 8 < C <= 64); each also takes a
batch of pairs in one launch sequence. The gather probe runs
through two more (``csrc/gather.cu``). All are built with ``nvcc`` for
``sm_90a`` at first use.
"""

__version__ = "0.1.0"
