"""Host-side WAV reading and writing."""
