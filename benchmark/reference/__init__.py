"""The benchmark's plain reference: a frozen copy of world_tpu_torch's plain
code paths (the DSP, Harvest, DIO, StoneMask, CheapTrick, both D4Cs, both
syntheses, the tables and seed banks, and the plain versions of kernels
K1-K7), with its imports made relative and every dispatcher sent to the
plain version on any device.  It imports nothing of the program: the
benchmark holds the program's outputs to it.  The round trips and the
facade's analysis and synthesis are in :mod:`.roundtrip` and
:mod:`.facade`."""
