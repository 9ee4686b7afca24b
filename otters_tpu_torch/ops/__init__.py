"""Device operators of the port: hashing, Bloom filters, zonemaps,
predicates, scoring and the fused top-k with its Hopper kernel."""
