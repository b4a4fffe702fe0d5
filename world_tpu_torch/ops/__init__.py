"""The hand-written CUDA kernels' wrappers: K1 (edge_interp, the event
engine) and K2 (refine_dft, Harvest refinement)."""
