"""deepglobalregistration_tpu_torch — Deep Global Registration in PyTorch for NVIDIA Hopper.

A port of the JAX package ``deepglobalregistration_tpu`` (kept beside it as
the reference). Module names mirror the JAX package so each counterpart is
easy to find: ``ops/`` (geometry, grids, kernel maps, sparse convolution,
1-NN, registration metrics, the training losses), ``models/`` (every model
of the JAX registry behind ``load_model``: ResUNet, SimpleNet, PyramidNet;
trainable, BN in train or eval mode), ``core/`` (refinement loop and the
``DeepGlobalRegistration`` pipeline, with ``register_batch``'s batched
program; the train step, the trainer, correspondence labels and the FCGF
hardest-contrastive step), ``utils/`` (device policy, checkpoint loading
of the reference's ``.pth`` files and loading and writing the JAX
package's native ones, weight conversion both ways, BN folding, PLY and
trajectory I/O, timers, TSDF fragment integration, torch.profiler traces),
``tools/`` (the gather probe, ``register_batch`` against ``register_many``,
the synthetic train -> validate -> benchmark chain, the bench-weights
export, the golden K-order check, the RANSAC budget sweep),
``data/`` (the 3DMatch, KITTI and synthetic pair datasets, collation into
``PairBatch`` and the loader factory; the KITTI ground-truth ICP runs on the
card), ``native.py`` (the ctypes binding of the repo's ``native/dgr_host.cpp``
host engine, built with ``g++`` into ``_build/``), ``config.py`` (every flag of
the JAX package's parser, plus ``--device``), and the evaluation entry points
``demo.py``, ``scripts/test_3dmatch.py`` and ``scripts/test_kitti.py``
(``scripts/analyze_stats.py`` reads their stats; ``scripts/train_*.sh`` are
the training recipes) and
the training entry point ``train.py`` (each ``main(argv=None)``, on the card
unless ``--device cpu``).

The 1-NN searches run through two hand-written CUDA kernels, chosen by the
rows' width: the ICP's xyz scan through a register-tiled CUDA-core scan
(``csrc/nn1_scan.cu``, C <= 8) and the feature match through a 3xTF32
tensor-core kernel (``csrc/nn1_mma.cu``, 8 < C <= 64); each also takes a
batch of pairs in one launch sequence. The gather probe runs
through two more (``csrc/gather.cu``). All are built with ``nvcc`` for
``sm_90a`` at first use.
"""

__version__ = "0.1.0"
