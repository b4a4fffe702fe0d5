"""Port of world_tpu/dsp."""
