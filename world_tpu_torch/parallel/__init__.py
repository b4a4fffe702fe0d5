"""Port of world_tpu/parallel."""
