"""Traffic kinds: `benchmark/kinds/<kind>.py` runs a cell whose traffic file
names it, through its `run(ctx) -> record`."""
