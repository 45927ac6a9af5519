"""What the benchmark's runs share: discovery of its data files, timing,
the trace summary, the operation and byte counts, seeded inputs and
weights, and the comparison that decides `correct`."""
