"""Traffic: the frozen chat corpus and the one generator."""
