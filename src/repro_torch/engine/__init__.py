"""Query engine: the shared per-batch artifacts (executor) and the per-kind
answers derived from them (assemble)."""
