"""Scripts that set the benchmark's limits and rates on the card; no run of
the benchmark calls them."""
