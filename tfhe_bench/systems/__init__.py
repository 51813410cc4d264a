"""One adapter a program entry point: `make(cfg, traffic, requests, seed,
device)` returns the system under test (`call`, `check`, `mark`,
`counters`, `shapes`, `close`, `units_per_call`)."""
