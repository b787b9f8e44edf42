"""The plain reference: PyTorch and NumPy only, float32, nothing of the
program. It redoes from the same inputs (points, weights, seed) what the
program derives: voxel selection, kernel maps, both nets, the 1-NN match,
the inlier weights, the refinement, ICP and the training step."""
