"""Port of world_tpu/spectral."""
