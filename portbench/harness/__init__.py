"""The benchmark's general code: loading cells by name, weights, FLOP and byte
counts, the device-trace reduction and the run's result line."""
