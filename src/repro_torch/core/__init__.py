"""Synopsis types, host build (partitioning, aggregates, stratified
samples) and query workloads."""
