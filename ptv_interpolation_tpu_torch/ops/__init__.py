"""Device primitives: neighbour search and the fused grid kNN kernel."""
