"""Port of `repro/sim`: the network model and the workload driver."""
