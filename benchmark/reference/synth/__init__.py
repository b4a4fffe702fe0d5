"""Port of world_tpu/synth."""
