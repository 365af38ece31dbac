"""The benchmark harness of repro_torch: traffic, deployment, comparison
and the reading of traced runs (see bench/README.md)."""
