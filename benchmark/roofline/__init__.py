"""Kernel rooflines: the least time of each hand-written kernel's work
(:mod:`.bounds`) and the capture and timing of its launches
(:mod:`.kernels`)."""
