"""The benchmark's own machinery: the manifest, the traffic generator, the
seeded weights, the trace reduction, the rooflines and the result line.
Nothing here imports the program under test; the adapters under
`h100_bench/models/` do."""
