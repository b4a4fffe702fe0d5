"""The benchmark's harness: one run of a cell (:mod:`.core`), the check of
its outputs (:mod:`.judge`) and what it reads off the card (:mod:`.trace`)."""
