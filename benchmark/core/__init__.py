"""The harness: the cell's files, the spans and the trace, the result."""
