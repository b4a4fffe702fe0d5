"""Port of world_tpu/aperiodicity."""
