"""Port of world_tpu/f0."""
